"""Persistent message queue: the async repair/delete bus.

Role parity: the reference pushes shard-repair and blob-delete events
through Kafka (blobstore/proxy/mq, scheduler/blob_deleter.go:315). A
broker dependency is out of scope for a storage framework's core, so
this is a durable append-log queue (jsonl + consumer offset file) with
the same at-least-once + ack semantics the consumers rely on.

Offsets are ABSOLUTE and never renumbered: compaction drops the acked
prefix by advancing a base watermark (recorded as the log's header
line), so offsets a consumer obtained from poll() before a compaction
stay valid for ack() after it — renumbering would turn in-flight acks
into destructive over-acks of unacked messages.

The port's copy of ``cubefs_tpu/blob/mq.py``: the local queue, and the
raft-replicated partitioned topic (``ReplicatedQueue``, whose members
are the schedulers) with its put-only client (``QueueProducer``, the
access role's), over the port's ``parallel/raft``. The raft groups
(``mq_<topic>_p<partition>``), their directories and the relay routes
(``mq_<topic>_put``/``_peek``/``_ack``) are the reference's.
"""

from __future__ import annotations

import json
import os

from ..utils import lockwitness


class MessageQueue:
    # acked prefix kept before compaction kicks in: bounds memory AND
    # restart-replay cost for high-volume topics (per-request S3 audit)
    COMPACT_THRESHOLD = 4096

    def __init__(self, path: str | None = None, topic: str = "q"):
        self._lock = lockwitness.make_lock("MessageQueue._lock")
        self._mem: list[dict] = []  # messages from absolute index _base
        self._base = 0  # absolute index of _mem[0]
        self._offset = 0  # absolute ack watermark (next to deliver)
        self._log = None
        self._offset_path = None
        if path:
            os.makedirs(path, exist_ok=True)
            log_path = os.path.join(path, f"{topic}.jsonl")
            self._offset_path = os.path.join(path, f"{topic}.offset")
            if os.path.exists(log_path):
                for line in open(log_path):
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        break
                    if isinstance(rec, dict) and "__base__" in rec:
                        self._base = int(rec["__base__"])
                    else:
                        self._mem.append(rec)
            if os.path.exists(self._offset_path):
                try:
                    self._offset = int(open(self._offset_path).read().strip() or 0)
                except ValueError:
                    self._offset = 0
            self._offset = max(self._offset, self._base)
            self._log = open(log_path, "a")

    def put(self, msg: dict) -> None:
        with self._lock:
            self._mem.append(msg)
            if self._log is not None:
                self._log.write(json.dumps(msg) + "\n")
                self._log.flush()

    def poll(self, max_n: int = 64) -> list[tuple[int, dict]]:
        """Peek up to max_n unacked messages as (absolute offset, msg);
        consumers ack() the highest offset they fully processed
        (at-least-once)."""
        with self._lock:
            start = max(self._offset, self._base)
            end = min(start + max_n, self._base + len(self._mem))
            return [(i, self._mem[i - self._base])
                    for i in range(start, end)]

    def ack(self, offset: int) -> None:
        with self._lock:
            self._offset = max(self._offset, offset + 1)
            if self._offset_path:
                with open(self._offset_path, "w") as f:
                    f.write(str(self._offset))
            if self._offset - self._base >= self.COMPACT_THRESHOLD:
                self._compact_locked()

    def _compact_locked(self) -> None:
        """Drop the acked prefix: rewrite the log as a base-header line
        plus the unacked tail (tmp + fsync + atomic replace). The offset
        file is untouched — offsets are absolute, so a crash anywhere in
        this sequence replays at-least-once and loses nothing. An I/O
        failure (e.g. ENOSPC) aborts the compaction with the queue fully
        usable: in-memory state and the append handle are only swapped
        after the replace succeeds."""
        keep = self._mem[self._offset - self._base:]
        new_base = self._offset
        if self._log is None:
            self._mem = keep
            self._base = new_base
            return
        log_path = self._log.name
        tmp = log_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                f.write(json.dumps({"__base__": new_base}) + "\n")
                for msg in keep:
                    f.write(json.dumps(msg) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, log_path)
            new_log = open(log_path, "a")
        except OSError:
            # abort: the original log file and append handle still stand
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return
        self._log.close()
        self._log = new_log
        self._mem = keep
        self._base = new_base

    def backlog(self) -> int:
        with self._lock:
            return self._base + len(self._mem) - max(self._offset, self._base)


# ---------------------------------------------------------------------------
# Replicated, partitioned bus — the Kafka-survivability analog.
#
# The single-node MessageQueue above is a durable log, but one lost node
# loses its pending repair/delete events. The reference rides Kafka
# (blobstore/proxy/mq, scheduler/blob_deleter.go:315) precisely for
# that durability. ReplicatedQueue keeps the same put/poll/ack/backlog
# interface while replicating each partition through its own raft group
# (parallel/raft.RaftNode): any majority of queue nodes preserves every
# unacked event, and partitions spread load across groups like topic
# partitions do.
#
# Offsets stay scalar for interface compatibility: the composite offset
# `idx * n_partitions + partition` round-trips through consumers that
# treat offsets as opaque (scheduler acks each polled offset).


class _PartitionFsm:
    """Deterministic queue state machine replicated by raft — a thin
    apply/snapshot adapter over a memory-only MessageQueue, so the
    offset/compaction invariants live in ONE place (the module
    docstring above). Compaction happens inside apply (MessageQueue.ack
    compacts past its threshold), keeping replicas identical."""

    def __init__(self):
        self.q = MessageQueue()  # path=None: raft owns durability

    def apply(self, rec: dict) -> dict:
        if rec["op"] == "put":
            self.q.put(rec["msg"])
        elif rec["op"] == "ack":
            self.q.ack(rec["idx"])
        return {}

    def state_bytes(self) -> bytes:
        with self.q._lock:
            return json.dumps({"mem": self.q._mem, "base": self.q._base,
                               "offset": self.q._offset}).encode()

    def restore_state(self, data: bytes) -> None:
        st = json.loads(data)
        with self.q._lock:
            self.q._mem = st["mem"]
            self.q._base = st["base"]
            self.q._offset = st["offset"]

    def peek(self, max_n: int):
        return self.q.poll(max_n)

    def backlog(self) -> int:
        return self.q.backlog()


class ReplicatedQueue:
    """Raft-replicated partitioned topic. Every member node constructs
    one with the same (topic, peers); mount `extra_routes` on the
    node's RPC server so raft traffic and peer relaying flow.

    put(), poll() and ack() all work from ANY member: operations on
    partitions led elsewhere relay to that partition's leader over the
    mq_* routes. ONE consumer (e.g. the scheduler leader — whose
    leadership is a DIFFERENT raft group) can therefore drain the whole
    topic; concurrent consumers merely re-deliver (at-least-once, the
    Kafka consumer contract the reference's scheduler already
    honors)."""

    def __init__(self, topic: str, me: str, peers: list[str], pool,
                 data_dir: str | None = None, n_partitions: int = 2):
        from ..parallel import raft as raftlib

        self.topic = topic
        self.me = me
        self.pool = pool
        self.n = n_partitions
        self.extra_routes: dict = {}
        self.fsms: list[_PartitionFsm] = []
        self.rafts: list = []
        self._rr = 0
        self._rr_lock = lockwitness.make_lock("ReplicatedQueue._rr_lock")
        for p in range(n_partitions):
            fsm = _PartitionFsm()
            node = raftlib.RaftNode(
                f"mq_{topic}_p{p}", me, peers, fsm.apply, pool,
                data_dir=(os.path.join(data_dir, f"mq_{topic}_p{p}")
                          if data_dir else None),
                snapshot_fn=fsm.state_bytes,
                restore_fn=fsm.restore_state,
            )
            raftlib.register_routes(self.extra_routes, node)
            self.fsms.append(fsm)
            self.rafts.append(node.start())
        # peer relaying: non-leader members forward puts/peeks/acks to
        # the partition leader over these routes
        self.extra_routes[f"mq_{topic}_put"] = self._rpc_put
        self.extra_routes[f"mq_{topic}_peek"] = self._rpc_peek
        self.extra_routes[f"mq_{topic}_ack"] = self._rpc_ack

    def stop(self) -> None:
        for node in self.rafts:
            node.stop()

    def _rpc_put(self, args, body):
        # one relay hop max: a producer hits any member, that member
        # forwards to the leader, the leader proposes locally
        self._propose_put(int(args["p"]), args["msg"],
                          forward=not args.get("hop"))
        return {}

    def _propose_put(self, p: int, msg: dict, forward: bool = True) -> None:
        from ..parallel.raft import NotLeaderError

        try:
            self.rafts[p].propose({"op": "put", "msg": msg})
            return
        except NotLeaderError as e:
            if not forward or not e.leader:
                raise
            leader = e.leader
        self.pool.get_direct(leader).call(
            f"mq_{self.topic}_put", {"p": p, "msg": msg, "hop": True},
            timeout=5.0)

    def put(self, msg: dict) -> None:
        with self._rr_lock:
            start = self._rr
            self._rr += 1
        last = None
        # try partitions round-robin so one leaderless group (mid
        # election) doesn't fail the producer
        for step in range(self.n):
            p = (start + step) % self.n
            try:
                self._propose_put(p, msg)
                return
            except Exception as e:
                last = e
        raise last

    def _rpc_peek(self, args, body):
        from ..utils import rpc as rpclib

        p = int(args["p"])
        st = self.rafts[p].status()
        if st["role"] != "leader":
            raise rpclib.RpcError(421, f"leader={st['leader'] or ''}")
        return {"items": self.fsms[p].peek(int(args.get("max_n", 64)))}

    def _rpc_ack(self, args, body):
        from ..parallel.raft import NotLeaderError

        try:
            self.rafts[int(args["p"])].propose(
                {"op": "ack", "idx": int(args["idx"])})
        except NotLeaderError:
            pass  # moved again: re-delivery is fine (at-least-once)
        return {}

    def poll(self, max_n: int = 64) -> list[tuple[int, dict]]:
        out: list[tuple[int, dict]] = []
        for p, (fsm, node) in enumerate(zip(self.fsms, self.rafts)):
            take = max_n - len(out)
            if take <= 0:
                break
            st = node.status()
            if st["role"] == "leader":
                items = fsm.peek(take)
            elif st["leader"]:
                try:
                    meta, _ = self.pool.get_direct(st["leader"]).call(
                        f"mq_{self.topic}_peek",
                        {"p": p, "max_n": take}, timeout=2.0)
                    items = meta["items"]
                except Exception:
                    continue  # leader mid-change: next poll catches up
            else:
                continue
            out.extend((int(idx) * self.n + p, msg) for idx, msg in items)
        return out

    def ack(self, offset: int) -> None:
        p = offset % self.n
        idx = offset // self.n
        from ..parallel.raft import NotLeaderError

        try:
            self.rafts[p].propose({"op": "ack", "idx": idx})
        except NotLeaderError as e:
            if not e.leader:
                return  # mid-election: the entry re-delivers
            try:
                self.pool.get_direct(e.leader).call(
                    f"mq_{self.topic}_ack", {"p": p, "idx": idx},
                    timeout=2.0)
            except Exception:
                pass  # re-delivered (at-least-once)

    def backlog(self) -> int:
        return sum(f.backlog() for f in self.fsms)

    def status(self) -> dict:
        return {"topic": self.topic, "partitions": [
            {"p": p, "role": node.status()["role"],
             "leader": node.status()["leader"],
             "backlog": fsm.backlog()}
            for p, (fsm, node) in enumerate(zip(self.fsms, self.rafts))]}


class QueueProducer:
    """Put-only client for a ReplicatedQueue hosted elsewhere (the
    proxy's producer role against Kafka): fires the event at any
    member, which relays it to the partition leader. MessageQueue-
    interface compatible for the producer half."""

    def __init__(self, topic: str, members: list[str], pool,
                 n_partitions: int = 2):
        self.topic = topic
        self.members = list(members)
        self.pool = pool
        self.n = n_partitions
        self._rr = 0
        self._lock = lockwitness.make_lock("QueueProducer._lock")

    def put(self, msg: dict) -> None:
        with self._lock:
            start = self._rr
            self._rr += 1
        last = None
        for step in range(len(self.members) * self.n):
            m = self.members[(start + step) % len(self.members)]
            p = (start + step) % self.n
            try:
                self.pool.get_direct(m).call(
                    f"mq_{self.topic}_put", {"p": p, "msg": msg},
                    timeout=5.0)
                return
            except Exception as e:
                last = e
        raise last

    def backlog(self) -> int:
        return 0  # producers don't track consumption
