"""Cross-cluster geo-replication gateway: cluster wiring for the
utils/georepl.py core.

Role parity: the reference runs whole standby regions fed by
asynchronous raft-log shipping with an operator-driven, fenced
promote/failback runbook; here ONE ``GeoGateway`` per cluster owns that
region's side of every replicated partition:

* On the serving side it installs the ``GeoShipper`` tap into each
  host's commit door (``MetaPartition.submit``/``submit_many``,
  ``ReplicatedFsm._commit``/``_commit_many``) and ``pump()`` ships the
  unacked tail to the peer gateway over ordinary RPC, healing sequence
  gaps from the shipper's bounded ring and falling back to a full
  snapshot bootstrap — ``fsm_recover_from_state`` generalized across
  clusters — over the PR 17 packet mux (OP_GEO_SNAPSHOT rides the
  FLAG_MORE chunk train, so a multi-MB partition image streams in
  CRC-checked chunks and a corrupt chunk poisons one transfer, not the
  shared connection).
* On the follower side it is the ONE RPC surface through which shipped
  records reach local FSMs (``rpc_geo_ship`` -> ``GeoApplier.deliver``
  -> host ``geo_apply``; lint CFG001 pins this), flips every host into
  follower mode (mutations bounce with GeoRedirect 452 toward the
  primary region; reads keep serving locally, feeding the follower's
  AZ-local flash tier), and answers resync instructions by pulling the
  primary's snapshot through the sdk ``WireClient`` (the CFX-sanctioned
  packet-plane home).
* Role changes go through ``transition()``: the fenced promote/failback
  state machine (utils/georepl.GeoController) plus the cluster-side
  effects — promote adopts the applier's position into the shipper so
  the partition keeps ONE logical sequence across the swap, demote
  marks every part for bootstrap (an old primary's unshipped divergent
  tail must be DISCARDED, never merged), resume_following folds a
  drained shipper position back into the applier for the graceful
  direction swap.

Raft-replicated hosts are refused: raft is the intra-region replication
plane, geo ships standalone-FSM clusters (one stream per partition, no
second consensus inside a region's group).

The port's copy of ``cubefs_tpu/fs/georepl.py``. The snapshot pull goes
through ``sdk.clients.WireClient``, as in the reference.
"""

from __future__ import annotations

import threading
import zlib

from ..utils import faultinject, lockwitness, metrics, packet, rpc
from ..utils import georepl as geo
from ..utils.retry import MONOTONIC

# states in which this cluster serves mutations and ships its commits
_SERVING = ("PRIMARY", "PROMOTED", "FAILBACK_SYNC")


class _Part:
    """One replicated partition: the host FSM plus its shipper/applier
    pair. Which half is live follows the gateway's controller state."""

    def __init__(self, gw: "GeoGateway", key: str, host, kind: str,
                 tenant: str, primary: str | None):
        self.key = key
        self.host = host
        self.kind = kind  # "mp" | "fsm"
        self.primary = primary  # peer-region addr mutations redirect to
        self.needs_bootstrap = False
        host.geo_part = key  # gate metrics label (cubefs_geo_redirects)
        self.shipper = geo.GeoShipper(
            key, epoch_fn=lambda: gw.controller.epoch, clock=gw.clock,
            tenant=tenant)
        state_path = None
        if gw.data_dir:
            state_path = f"{gw.data_dir}/geo_{key.replace(':', '_')}.json"
        self.applier = geo.GeoApplier(
            key, apply_fn=host.geo_apply, clock=gw.clock, tenant=tenant,
            state_path=state_path)

    def _set_mode(self, mode: str | None) -> None:
        if self.kind == "fsm":
            self.host.geo_set_mode(mode, self.primary)
        else:
            self.host.geo_mode = mode
            self.host.geo_primary = self.primary

    def set_role(self, serving: bool, fenced: bool) -> None:
        if serving:
            self._set_mode(None)
            # tap installed BEFORE activating: commits racing the flip
            # are either pre-tap (recovered via bootstrap) or sequenced
            self.shipper.active = True
            self.host.geo_tap = self.shipper.tap
            self.applier.fenced = False  # epoch armor, not the fence,
            # rejects a healed old primary's stream (the counter test)
        else:
            self.host.geo_tap = None
            self.shipper.active = False
            self._set_mode("follower")
            self.applier.fenced = fenced

    def snapshot_with_seq(self) -> tuple[bytes, int]:
        """(state, ship-seq) captured under the host's COMMIT lock —
        the same lock every tap fires under post-apply, so the pair is
        exactly consistent: a bootstrapped follower resumes the stream
        at seq+1 with no lost or double-applied record around the
        snapshot point."""
        if self.kind == "mp":
            with self.host._lock:
                return self.host.state_bytes(), self.shipper.seq
        with self.host._wal_lock:
            return self.host._state_bytes(), self.shipper.seq

    def restore(self, data: bytes) -> None:
        if self.kind == "mp":
            self.host.restore_state(data)
            if self.host.data_dir:
                self.host.snapshot()  # checkpoint; oplog restarts clean
        else:
            self.host.fsm_recover_from_state(data)


class GeoGateway:
    """Per-cluster geo endpoint: rpc_* surface for the peer region,
    pump loop for the serving side, transition orchestration for the
    operator (cubefs-cli geo)."""

    def __init__(self, cluster: str, pool, addr: str,
                 peer_addr: str | None = None, role: str = "primary",
                 data_dir: str | None = None, clock=MONOTONIC):
        if not geo.enabled():
            raise RuntimeError(
                "geo-replication is behind CUBEFS_GEO (default off)")
        self.cluster = cluster
        self.pool = pool
        self.addr = addr
        self.peer_addr = peer_addr
        self.data_dir = data_dir
        self.clock = clock
        self.controller = geo.GeoController(
            cluster, state="PRIMARY" if role == "primary" else "FOLLOWING")
        self._parts: dict[str, _Part] = {}
        self._wires: dict[str, object] = {}
        self._lock = lockwitness.make_rlock("GeoGateway._lock")
        self._pkt = None
        self.packet_addr: str | None = None
        self._stop_evt: threading.Event | None = None
        self._thread: threading.Thread | None = None
        pool.bind(addr, self)

    # ---------------- wiring ----------------
    def attach_metanode(self, node, primaries: dict | None = None,
                        tenant: str = "fs") -> list[str]:
        """Register every standalone partition of a metanode. `primaries`
        maps pid -> the primary REGION's metanode addr (what redirected
        mutations retry against)."""
        keys = []
        for pid, mp in sorted(node.partitions.items()):
            if pid in node.rafts:
                raise RuntimeError(
                    f"mp {pid} is raft-replicated; geo ships "
                    "standalone-FSM clusters only")
            keys.append(self._attach(
                f"mp:{pid}", mp, "mp", tenant, (primaries or {}).get(pid)))
        return keys

    def attach_fsm(self, name: str, host, primary: str | None = None,
                   tenant: str | None = None) -> str:
        """Register a ReplicatedFsm host (master / clustermgr FSM)."""
        if host.raft is not None:
            raise RuntimeError(
                f"fsm {name!r} is raft-replicated; geo ships "
                "standalone-FSM clusters only")
        return self._attach(f"fsm:{name}", host, "fsm", tenant or name,
                            primary)

    def _attach(self, key: str, host, kind: str, tenant: str,
                primary: str | None) -> str:
        with self._lock:
            part = _Part(self, key, host, kind, tenant, primary)
            self._parts[key] = part
            part.set_role(serving=self.controller.state in _SERVING,
                          fenced=self.controller.state == "FENCED")
        return key

    def _part(self, key: str) -> _Part:
        with self._lock:
            part = self._parts.get(key)
        if part is None:
            raise rpc.RpcError(404, f"unknown geo part {key!r}")
        return part

    # ---------------- role transitions ----------------
    def transition(self, op: str, op_id: str | None = None) -> dict:
        """Controller edge + cluster-side effects, atomically under the
        gateway lock. op_id replays return the recorded outcome WITHOUT
        re-running side effects — a retried promote must not re-adopt
        (the shipper may have advanced past the adoption point)."""
        with self._lock:
            if op == "promote":
                # fence ABOVE every epoch this cluster has ever applied
                for part in self._parts.values():
                    self.controller.observe_epoch(part.applier.epoch)
            out = self.controller.transition(op, op_id=op_id)
            if out.get("replayed"):
                return out
            if op == "promote":
                for part in self._parts.values():
                    # continue the partition's ONE logical sequence from
                    # where this side's applier left it
                    part.applier.adopt(part.applier.applied_seq,
                                       self.controller.epoch)
                    part.shipper.adopt(part.applier.applied_seq)
                    part.needs_bootstrap = False
            elif op == "demote":
                for part in self._parts.values():
                    # an old primary's unshipped tail is DIVERGENT
                    # history: discard via snapshot bootstrap, never
                    # merge it into the new primary's stream
                    part.needs_bootstrap = True
            elif op == "resume_following":
                for part in self._parts.values():
                    # graceful direction swap after a drained fence:
                    # local state == shipped history, so the applier
                    # resumes at this side's own ship position
                    part.applier.adopt(
                        max(part.applier.applied_seq, part.shipper.seq),
                        self.controller.epoch)
            self._sync_roles()
            return out

    def _sync_roles(self) -> None:
        st = self.controller.state
        for part in self._parts.values():
            part.set_role(serving=st in _SERVING, fenced=st == "FENCED")

    # ---------------- serving side: the pump ----------------
    def pump(self, max_records: int = 256,
             backfill_rounds: int = 4) -> dict:
        """Ship every part's unacked tail to the peer gateway; heal
        reported gaps from the ring (bounded rounds) and instruct a
        snapshot resync on a ring miss or an explicit bootstrap ask.
        Returns per-part outcomes (tests/bench drive this directly; the
        background loop in start() just calls it on an interval)."""
        if self.controller.state not in _SERVING or not self.peer_addr:
            return {}
        with self._lock:
            parts = dict(self._parts)
        peer = self.pool.get(self.peer_addr)
        out = {}
        # sender identity keys one-way partition rules (a region that
        # can hear but not be heard keeps receiving acks it can't earn)
        with faultinject.sender(self.addr):
            for key, part in sorted(parts.items()):
                try:
                    out[key] = self._pump_part(
                        peer, key, part, max_records, backfill_rounds)
                except rpc.RpcError as e:
                    out[key] = {"error": f"{e.code}: {e.message}"}
                except OSError as e:
                    out[key] = {"error": str(e)}
        return out

    def _pump_part(self, peer, key: str, part: _Part, max_records: int,
                   rounds: int) -> dict:
        lines = part.shipper.pending(max_records)
        reply, _ = peer.call("geo_ship", {"part": key, "lines": lines})
        for _ in range(rounds):
            if reply.get("fenced"):
                break
            if reply.get("bootstrap"):
                reply = self._instruct_resync(peer, key)
                break
            need = reply.get("need")
            if need is None:
                break
            fill = part.shipper.backfill(int(need))
            if fill is None:  # ring wrapped past the gap: full transfer
                reply = self._instruct_resync(peer, key)
                break
            metrics.geo_backfills.inc(part=key, kind="ring")
            reply, _ = peer.call("geo_ship", {"part": key, "lines": fill})
        acked = part.shipper.ack(int(reply["applied_seq"]))
        return {"applied_seq": int(reply["applied_seq"]), "acked": acked,
                "fenced": bool(reply.get("fenced")),
                "pending_bytes": part.shipper.pending_bytes()}

    def _instruct_resync(self, peer, key: str) -> dict:
        """Tell the follower to pull a full snapshot of `key` from this
        side (packet mux when served, rpc fallback otherwise)."""
        reply, _ = peer.call("geo_resync", {
            "part": key, "packet_addr": self.packet_addr,
            "from": self.addr})
        return {"applied_seq": reply["applied_seq"],
                "epoch": reply["epoch"], "need": None, "fenced": False}

    def start(self, interval: float = 0.05) -> None:
        """Background pump loop (bench/daemon mode; tests pump
        explicitly for deterministic schedules)."""
        if self._thread is not None:
            return
        self._stop_evt = threading.Event()

        def loop():
            while not self._stop_evt.wait(interval):
                try:
                    self.pump()
                except Exception:  # noqa: BLE001 - keep the loop alive
                    pass

        self._thread = threading.Thread(
            target=loop, daemon=True, name=f"geo-pump-{self.cluster}")
        self._thread.start()

    def close(self) -> None:
        if self._stop_evt is not None:
            self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if self._pkt is not None:
            self._pkt.stop()
            self._pkt = None
        with self._lock:
            wires, self._wires = dict(self._wires), {}
        for wc in wires.values():
            wc.close()

    # ---------------- follower side: rpc surface ----------------
    def rpc_geo_ship(self, args, body):
        """Peer pump -> local applier. The applier is the ONE door into
        the host FSMs (lint CFG001): epoch fencing, duplicate skip and
        gap detection all live behind it."""
        part = self._part(args["part"])
        if part.needs_bootstrap:
            return {"applied_seq": part.applier.applied_seq,
                    "epoch": part.applier.epoch, "need": None,
                    "fenced": False, "bootstrap": True}
        out = part.applier.deliver(args.get("lines") or [])
        self.controller.observe_epoch(part.applier.epoch)
        return out

    def rpc_geo_resync(self, args, body):
        """Primary-instructed full bootstrap: pull the snapshot, adopt
        (state, seq, epoch) in one step. Idempotent by contract — the
        transfer lands the primary's CURRENT image, so replaying it
        converges to the same state."""
        part = self._part(args["part"])
        meta, payload = self._pull_snapshot(part, args.get("packet_addr"))
        if zlib.crc32(payload) != meta["crc"]:
            raise rpc.RpcError(
                502, f"geo snapshot crc mismatch for {part.key}")
        part.applier.bootstrap(payload, meta["seq"], meta["epoch"],
                               part.restore)
        part.needs_bootstrap = False
        self.controller.observe_epoch(int(meta["epoch"]))
        return {"applied_seq": part.applier.applied_seq,
                "epoch": part.applier.epoch}

    def _pull_snapshot(self, part: _Part, packet_addr: str | None):
        if packet_addr:
            # multi-MB partition images ride the mux's FLAG_MORE chunk
            # train: per-chunk CRC, one corrupt chunk poisons this
            # transfer only (PacketError), never the shared connection.
            # The mux hands back a memoryview over its receive buffer —
            # materialize it before the buffer is recycled.
            meta, payload = self._wire(packet_addr).call(
                packet.OP_GEO_SNAPSHOT, args={"part": part.key})
            return meta, bytes(payload)
        if not self.peer_addr:
            raise rpc.RpcError(503, "no peer to bootstrap from")
        return self.pool.get(self.peer_addr).call(
            "geo_snapshot", {"part": part.key})

    def _wire(self, addr: str):
        with self._lock:
            wc = self._wires.get(addr)
            if wc is None:
                from ..sdk.clients import WireClient
                wc = WireClient(addr)
                self._wires[addr] = wc
            return wc

    def rpc_geo_snapshot(self, args, body):
        """RPC fallback for the snapshot pull (tests without a packet
        server); same atomic (state, seq) capture as the mux path."""
        part = self._part(args["part"])
        data, seq = part.snapshot_with_seq()
        return ({"crc": zlib.crc32(data), "seq": seq,
                 "epoch": self.controller.epoch}, data)

    def rpc_geo_status(self, args, body):
        return self.status()

    def rpc_geo_transition(self, args, body):
        return self.transition(args["op"], op_id=args.get("op_id"))

    def status(self) -> dict:
        with self._lock:
            parts = dict(self._parts)
        ps = {}
        for key, part in sorted(parts.items()):
            ps[key] = {
                "ship_seq": part.shipper.seq,
                "applied_seq": part.applier.applied_seq,
                "epoch": part.applier.epoch,
                "pending_bytes": part.shipper.pending_bytes(),
                "needs_bootstrap": part.needs_bootstrap,
            }
        return {"cluster": self.cluster, "state": self.controller.state,
                "epoch": self.controller.epoch, "peer": self.peer_addr,
                "packet_addr": self.packet_addr, "parts": ps}

    # ---------------- packet plane (snapshot/backfill transfers) ------
    def serve_packets(self, host: str = "127.0.0.1", port: int = 0,
                      workers: int = 2):
        """Binary plane for bulk geo transfers. Payloads above the mux
        chunk size stream as FLAG_MORE trains automatically."""

        def wrap(fn):
            def handler(hdr, args, payload):
                try:
                    return fn(hdr, args, payload)
                except rpc.RpcError as e:
                    raise packet.PacketError(
                        packet.RESULT_RPC, e.message, code=e.code) from e
            return handler

        def snap(hdr, args, payload):
            part = self._part(args["part"])
            data, seq = part.snapshot_with_seq()
            return ({"crc": zlib.crc32(data), "seq": seq,
                     "epoch": self.controller.epoch}, data)

        def backfill(hdr, args, payload):
            part = self._part(args["part"])
            lines = part.shipper.backfill(int(args["from_seq"]))
            if lines is None:
                return {"miss": True, "count": 0}, b""
            return ({"miss": False, "count": len(lines)},
                    "".join(lines).encode())

        srv = packet.PacketServer(
            {packet.OP_GEO_SNAPSHOT: wrap(snap),
             packet.OP_GEO_BACKFILL: wrap(backfill)},
            host, port, service="geo", workers=workers)
        self._pkt = srv.start()
        self.packet_addr = self._pkt.addr
        return self._pkt
