"""The port's operator plane (``cubefs_tpu_torch/cli.py``, ``tool/snapshot.py``,
``tool/autofs.py``) held against the reference's on the CPU.

- every scenario of the reference's ``tests/test_ops_tools.py`` runs on the
  port (``port_copy``), and ``test_gateways.py``'s
  ``test_launcher_and_cli_end_to_end`` starts the port's roles with
  ``python -m cubefs_tpu_torch.cmd`` and drives them with ``python -m
  cubefs_tpu_torch.cli``;
- each metrics view of the port's CLI, fed the same ``/metrics`` text as
  the reference's, returns an equal dict; both CLIs return equal JSON for
  the same commands against one port master over HTTP;
- a snapshot exported by either package's tool restores in the other to the
  partitions' live state;
- the CLI against a launched cluster over sockets (the launcher's master,
  3 metanodes and 4 datanodes at replicas 3): its per-node calls reach the
  named node, not a leader some client learned; importing the CLI loads
  no torch.

Tolerance: exact equality.
"""

import functools
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from cubefs_tpu_torch import cli
from cubefs_tpu_torch.blob import blobnode, scheduler
from cubefs_tpu_torch.deploy import cluster as deploy
from cubefs_tpu_torch.tool import snapshot
from cubefs_tpu_torch.utils import metrics, rpc
from test_torch_fs import (FS_E2E, PORT, WireFs, _close, _port_qos_still, both,  # noqa: F401
                           first_mkdir, ref, wait_for)
from test_torch_raft import port_copy, run_scenario, scenarios

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

OPS = port_copy("test_ops_tools",
                Scheduler=functools.partial(scheduler.Scheduler, device="cpu"),
                BlobNode=functools.partial(blobnode.BlobNode, device="cpu"))
GATEWAYS = port_copy("test_gateways", FsCluster=FS_E2E.FsCluster)
cluster = OPS.cluster  # the scenarios' fixture


@pytest.mark.parametrize("name", scenarios(OPS))
def test_reference_ops_tools_scenario_on_the_port(name, request):
    run_scenario(OPS, name, request)


def test_every_ops_tools_scenario_runs():
    assert len(scenarios(OPS)) == 10


def test_reference_launcher_and_cli_end_to_end_on_the_port(request):
    run_scenario(GATEWAYS, "test_launcher_and_cli_end_to_end", request)


def test_importing_the_cli_loads_no_torch():
    code = ("import sys\nimport cubefs_tpu_torch.cli\n"
            "import cubefs_tpu_torch.fs.fsck, cubefs_tpu_torch.fs.scrub\n"
            "import cubefs_tpu_torch.tool.snapshot, cubefs_tpu_torch.tool.autofs\n"
            "import cubefs_tpu_torch.blob.dial, cubefs_tpu_torch.blob.bench_tool\n"
            "import cubefs_tpu_torch.tool.loadgen\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('torch', 'jax'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=60)


# ---------------- the metrics views, against the reference's ----------------

VIEWS = ["write_path", "codec", "repair", "read_path", "wire", "geo", "meta", "qos",
         "tiering", "integrity", "slo"]

# one series of every family some view reads, beside the port's live registry
SYNTHETIC = """\
cubefs_raft_proposals_total{group="mp1"} 12
cubefs_raft_proposal_batches_total{group="mp1"} 4
cubefs_raft_wal_fsyncs_total 3
cubefs_raft_batch_apply_seconds_sum 0.5
cubefs_raft_batch_apply_seconds_count 4
cubefs_meta_batch_entries_total 2
cubefs_meta_batched_ops_total 9
cubefs_raft_pipelined_appends_total 5
cubefs_raft_inflight_window_sum 10
cubefs_raft_inflight_window_count 4
cubefs_raft_mux_jobs_total{kind="append"} 7
cubefs_raft_mux_senders 2
cubefs_meta_fanout_batches_total 3
cubefs_meta_fanout_ops_total 12
cubefs_meta_fanout_partitions_inflight_sum 6
cubefs_meta_fanout_partitions_inflight_count 3
cubefs_codec_batch_submissions_total{op="encode"} 64
cubefs_codec_batch_steps_total{op="encode",engine="cuda"} 8
cubefs_codec_batch_stripes_per_step_sum{op="encode"} 64
cubefs_codec_batch_stripes_per_step_count{op="encode"} 8
cubefs_codec_batch_wait_seconds_sum{op="encode"} 0.02
cubefs_codec_batch_wait_seconds_count{op="encode"} 64
cubefs_codec_batch_dp_steps_total{dp="2"} 1
cubefs_codec_bytes_total{engine="cuda"} 4096
cubefs_codec_program_cache_total{family="rs",event="hit"} 3
cubefs_codec_program_cache_entries 1
cubefs_repair_codec_leg_total{leg="cuda"} 2
cubefs_repair_bytes_pulled_total{scope="az_local"} 100
cubefs_repair_bytes_pulled_total{scope="cross_az"} 50
cubefs_repair_msr_fallback_total{reason="helper_dead"} 1
cubefs_repair_subshard_reads_total 11
cubefs_repair_tasks_total{state="done"} 4
cubefs_flashcache_ops_total{result="hit"} 6
cubefs_flashcache_ops_total{result="miss"} 2
cubefs_readcache_serves_total{scope="az_local"} 5
cubefs_readcache_fills_total{outcome="filled"} 2
cubefs_pkt_frames_total{side="server",dir="rx"} 40
cubefs_pkt_chunk_bytes_total{side="client",dir="tx"} 8192
cubefs_pkt_mux_conns 2
cubefs_pkt_mux_streams 6
cubefs_pkt_mux_queue_wait_seconds_sum 0.01
cubefs_pkt_mux_queue_wait_seconds_count 5
cubefs_pkt_stream_drops_total{side="client"} 1
cubefs_geo_lag_seconds{part="mp:1"} 0.25
cubefs_geo_rpo_bytes{part="mp:1"} 512
cubefs_geo_applied_total{part="mp:1",outcome="applied"} 9
cubefs_geo_state{cluster="r1"} 3
cubefs_geo_epoch{cluster="r1"} 2
cubefs_geo_backfills_total{kind="ring"} 1
cubefs_meta_partition_imbalance 0.5
cubefs_meta_range_migrations_total{kind="split"} 1
cubefs_meta_range_migration_aborts_total{reason="fenced"} 1
cubefs_meta_range_redirects_total 3
cubefs_qos_admitted_total{tenant="a"} 10
cubefs_qos_shed_total{tenant="a",reason="quota"} 2
cubefs_qos_brownout_level{path="blob.get"} 1
cubefs_slo_burn_rate{path="blob.get"} 2.5
cubefs_qos_inflight{path="blob.get"} 3
cubefs_tiering_transitions_total{outcome="committed"} 2
cubefs_tiering_bytes_total{direction="to_cold"} 1024
cubefs_tiering_blob_freelist 1
cubefs_integrity_corruptions_detected_total{plane="fs",source="scrub"} 1
cubefs_integrity_corruptions_healed_total{plane="fs",source="scrub"} 1
cubefs_scrub_items_total{plane="fs",outcome="clean"} 7
cubefs_slo_latency_quantile_seconds{path="blob.get",quantile="0.99"} 0.012
cubefs_slo_error_budget_remaining{path="blob.get"} 0.9
cubefs_request_stage_seconds_count{path="blob.get",stage="total"} 40
cubefs_slow_traces_total{path="blob.get"} 1
"""


@pytest.fixture(scope="module")
def ref_cli():
    from cubefs_tpu import cli as ref_cli

    return ref_cli


@pytest.mark.parametrize("view", VIEWS)
def test_each_metrics_view_equals_the_references_on_the_same_text(view, ref_cli):
    """The port's registry as this process left it, with a series of every
    family some view reads added: each view of the port returns the
    reference's dict."""
    text = metrics.DEFAULT.render_text() + SYNTHETIC
    port = getattr(cli, f"_{view}_view")(text)
    assert port == getattr(ref_cli, f"_{view}_view")(text)
    assert port  # a view of something


def _json_out(mod, argv, capsys):
    mod.main(argv)
    return json.loads(capsys.readouterr().out)


def test_both_clis_return_equal_json_against_one_port_master(cluster, ref_cli, capsys):
    """The same commands, each CLI in turn, against one port master over
    HTTP: equal JSON."""
    srv = rpc.RpcServer(rpc.expose(cluster.master), service="master").start()
    try:
        cluster.fs.mkdir("/q")
        m = ["--master", srv.addr]
        commands = [["cluster", "stat", *m], ["vol", "view", "opvol", *m],
                    ["node", "list", *m], ["mp", "check", *m], ["dp", "view", *m, "--vol", "opvol"],
                    ["dp", "check", *m], ["quota", "list", *m, "--vol", "opvol"],
                    ["topology", "fs", *m], ["topology", "tree", *m],
                    ["meta", "status", *m, "--vol", "opvol"], ["user", "list", *m]]
        for argv in commands:
            assert _json_out(cli, argv, capsys) == _json_out(ref_cli, argv, capsys), argv
        # a write through each leaves the same answers behind
        for mod, name in ((cli, "port"), (ref_cli, "ref")):
            _json_out(mod, ["user", "create", *m, "--user-id", f"u-{name}"], capsys)
        users = _json_out(cli, ["user", "list", *m], capsys)
        assert users == _json_out(ref_cli, ["user", "list", *m], capsys)
        assert {u["user_id"] for u in users.values()} >= {"u-port", "u-ref"}
    finally:
        srv.stop()


# ---------------- snapshots across the packages ----------------

def _partition_states(mn_mod, manifest, root) -> dict:
    out = {}
    for m in manifest["mps"]:
        part = mn_mod.MetaPartition(m["pid"], m["start"], m["end"],
                                    data_dir=os.path.join(root, f"mp_{m['pid']}"))
        out[m["pid"]] = (part.apply_id, part.export_state()[0])
    return out


@pytest.mark.parametrize("exporter", ["port", "ref"])
def test_a_snapshot_restores_in_the_other_package(exporter, ref, tmp_path):
    """A port cluster over sockets; either package's tool exports the
    volume, and both packages restore the archive: every restored
    partition's state equals the live partition's and the other
    package's restore."""
    from cubefs_tpu.fs import metanode as ref_mn
    from cubefs_tpu.tool import snapshot as ref_snapshot
    from cubefs_tpu_torch.fs import metanode as port_mn

    c = WireFs(PORT, tmp_path)
    fs = PORT.FileSystem(c.view, PORT.rpc.NodePool())
    try:
        first_mkdir(fs, "/keep")
        for i, data in enumerate((b"alpha", b"beta" * 1000, bytes(range(256)) * 300)):
            fs.write_file(f"/keep/f{i}", data)
        fs.rename("/keep/f0", "/keep/renamed")
        tools = {"port": (snapshot, PORT.rpc.NodePool), "ref": (ref_snapshot, ref.rpc.NodePool)}
        tool, pool = tools[exporter]
        out = str(tmp_path / "snap")
        manifest = tool.export(c.master_addr, "mix", out, pool=pool())
        assert len(manifest["mps"]) == 2
        assert snapshot.verify(out) == ref_snapshot.verify(out) == manifest

        def converged():  # every replica of a partition at the same state
            states = {}
            for meta in c.metas:
                for pid, part in meta.partitions.items():
                    states.setdefault(pid, set()).add((part.apply_id, part.export_state()[0]))
            return ({pid: st.pop() for pid, st in states.items()}
                    if all(len(st) == 1 for st in states.values()) else None)
        live = wait_for(converged, what="the replicas to converge")
        restored = {}
        for name, (mod, mn_mod) in {"port": (snapshot, port_mn),
                                    "ref": (ref_snapshot, ref_mn)}.items():
            root = str(tmp_path / f"restored-{name}")
            assert sorted(mod.restore(out, root)) == sorted(m["pid"] for m in manifest["mps"])
            restored[name] = _partition_states(mn_mod, manifest, root)
        assert restored["port"] == restored["ref"]
        assert restored["port"] == {pid: live[pid] for pid in restored["port"]}
    finally:
        _close(fs)
        c.stop()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_a_first_mkdir_whose_commit_times_out_after_it_lands(pkg, ref, tmp_path):
    """The snapshot test's first mkdir, with the root partition's raft
    appends held 5.5 s by ``faultinject`` while it is first tried: its
    leader answers 500 ``entry N not committed in time`` (raft's 5 s) and
    the entry lands after, in either package's cluster and client. Every
    later try is a new operation and answers EEXIST: a wait for a mkdir
    that succeeds runs out on it; ``first_mkdir`` takes it, after the
    failed try, as the directory that try made."""
    p = both(ref)[pkg]
    c = WireFs(p, tmp_path)
    fs = p.FileSystem(c.view, p.rpc.NodePool())
    tried = []

    def mkdir_first_held(path):
        if path in tried:
            return fs.mkdir(path)
        tried.append(path)
        held = p.faultinject.FaultPlan(seed=1).on(method="raft_mp1_append", kind="delay",
                                                  delay=5.5)
        with p.faultinject.installed(held):
            with pytest.raises(p.rpc.RpcError, match="500.*not committed in time"):
                fs.mkdir(path)
        raise FileNotFoundError(f"{path}: the first try failed")

    try:
        wait_for(lambda: fs.meta.inode_get(1), what="the root partition's leader")
        with pytest.raises(AssertionError, match="first mkdir: .*'waited' exists"):
            wait_for(lambda: mkdir_first_held("/waited"), timeout=14.0, what="the first mkdir")
        assert first_mkdir(types.SimpleNamespace(mkdir=mkdir_first_held), "/keep")
        assert tried == ["/waited", "/keep"]
        assert sorted(fs.readdir("/")) == ["keep", "waited"]
        assert fs.meta.inode_get(fs.resolve("/keep"))["type"] == "dir"
    finally:
        _close(fs)
        c.stop()


# ---------------- the CLI against a launched cluster ----------------

@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The launcher's file-system plane on the CPU: a master, 3 metanodes
    and 4 datanodes at replicas 3, a volume of 2 meta and 3 data
    partitions, each a process of its own."""
    wd = tmp_path_factory.mktemp("operators")
    c = deploy.Cluster({"metanodes": 3, "datanodes": 4, "replicas": 3,
                        "volume": {"name": "opsvol", "mp_count": 2, "dp_count": 3},
                        "device": "cpu"}, str(wd), timeout=120.0)
    try:
        state = c.up()
        yield c, state, wd
    finally:
        codes = c.down()
    assert all(rc == 0 for rc in codes.values()), codes


def _cli(*args, check=True) -> str:
    out = subprocess.run([sys.executable, "-m", "cubefs_tpu_torch.cli", *args],
                         capture_output=True, text=True, cwd=ROOT, timeout=120)
    if check:
        assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_cli_against_the_launched_cluster(launched, tmp_path, rng):
    """An operator's work over sockets: files in and out, listings and
    views; ``dp raft-status`` of each replica answers that replica's own
    role (a follower answers follower, even after a client of the
    volume learned the leader from a 421); ``node decommission`` drains
    the named datanode and the files still read back."""
    c, state, wd = launched
    master = state["roles"]["master"][0]
    m = ["--master", master]
    v = [*m, "--vol", "opsvol"]
    assert len(json.loads(_cli("cluster", "stat", *m))["volumes"]) == 1
    payloads = {f"/ops/f{i}": rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                for i, n in enumerate((300_001, 70_000))}
    # the first mkdir waits out the partitions' elections
    wait_for(lambda: "ops" in _cli("fs", "mkdir", "/ops", *v, check=False)
             + _cli("fs", "ls", "/", *v, check=False), 60.0, "mkdir /ops")
    for path, data in payloads.items():
        src = tmp_path / os.path.basename(path)
        src.write_bytes(data)
        _cli("fs", "put", str(src), path, *v)
    _cli("fs", "mv", "/ops/f1", "/ops/moved", *v)
    listing = _cli("fs", "ls", "/ops", *v)
    assert "f0" in listing and "moved" in listing and "f1" not in listing
    stat = json.loads(_cli("fs", "stat", "/ops/f0", *v))
    assert stat["size"] == len(payloads["/ops/f0"])
    dst = tmp_path / "back"
    _cli("fs", "get", "/ops/moved", str(dst), *v)
    assert dst.read_bytes() == payloads["/ops/f1"]
    dp_view = [dict(d, dp_id=int(k))
               for k, d in json.loads(_cli("dp", "view", *v))["dps"].items()]
    assert len(dp_view) == 3 and all(len(d["replicas"]) == 3 for d in dp_view)
    def statuses(dp) -> dict | None:
        got = {a: json.loads(_cli("dp", "raft-status", "--datanode", a,
                                  "--dp-id", str(dp["dp_id"])))["status"]
               for a in dp["replicas"]}
        leaders = {st["leader"] for st in got.values()}
        return got if len(leaders) == 1 and leaders.pop() in got else None

    for dp in dp_view:
        got = wait_for(lambda: statuses(dp), 30.0, f"dp {dp['dp_id']}'s leader")
        for addr, st in got.items():
            # each node answers its own role: the call reached that node
            assert st["role"] == ("leader" if addr == st["leader"] else "follower"), got
    nodes = json.loads(_cli("node", "list", *m))["datanodes"]
    assert len(nodes) == 4
    victim = dp_view[0]["replicas"][-1]
    assert json.loads(_cli("node", "decommission", *m, "--addr", victim))
    assert json.loads(_cli("node", "list", *m))["datanodes"][victim]["decommissioned"]
    view = json.loads(_cli("vol", "view", "opsvol", *m))["volume"]
    assert all(victim not in d["replicas"] for d in view["dps"])
    _cli("fs", "get", "/ops/f0", str(dst), *v)
    assert dst.read_bytes() == payloads["/ops/f0"]
    _cli("fs", "rm", "/ops/f0", *v)
    assert "f0" not in _cli("fs", "ls", "/ops", *v)
    wire = json.loads(_cli("metrics", "wire", "--addr", master))
    assert set(wire) == {"frames", "bytes", "mux", "stream_drops"}


# ---------------- two volumes on one metanode ----------------

@pytest.mark.parametrize("pkg_name", ["port", "ref"])
def test_a_walk_stays_in_its_volume_on_a_node_hosting_two(pkg_name, ref, tmp_path):
    """Every volume's first partition starts at inode 1, so a metanode
    hosting two volumes holds two roots numbered 1. A walk names its
    partition (the client's ``_call_wire`` adds ``pid``): the port's
    ``rpc_walk`` and native plane read that partition alone and find
    volume B's file; the reference's walk searches by range, meets volume
    A's root first and answers ENOENT (402) for a file that exists: a
    ``vol create`` beside a live volume made ``cfs_open`` of a file in the
    first fail on the card."""
    from cubefs_tpu_torch.utils import packet as pkt

    pkg = {"port": PORT, "ref": ref}[pkg_name]
    node = pkg.MetaNode(0, data_dir=str(tmp_path / "meta"))
    try:
        for pid, name in ((1, "in_a"), (2, "in_b")):  # volumes A and B
            node.create_partition(pid, 1, 1 << 24)
            node.rpc_submit({"pid": pid, "record": {"op": "mknod", "parent": 1, "name": name,
                                                    "type": "file", "mode": 0o644}}, b"")
        want = node.partitions[2].lookup(1, "in_b")
        walk = {"pid": 2, "ino": 1, "names": ["in_b"]}
        if pkg_name == "ref":
            with pytest.raises(ref.rpc.RpcError) as e:
                node.rpc_walk(walk, b"")
            assert e.value.code == 402 and "'in_b' not in 1" in e.value.message
            return
        assert node.rpc_walk(walk, b"") == {"ino": want, "remaining": []}
        assert node.rpc_walk({"pid": 1, "ino": 1, "names": ["in_a"]}, b"")["ino"] \
            == node.partitions[1].lookup(1, "in_a")
        node.serve_native()
        cli = pkt.PacketClient(node.native_addr, timeout=5.0)
        try:
            for pid, name in ((2, "in_b"), (1, "in_a")):
                got, _ = cli.call(pkt.OP_META_WALK, args={"pid": pid, "ino": 1, "names": [name],
                                                          "stat": True})
                assert got["ino"] == node.partitions[pid].lookup(1, name)
                assert got["remaining"] == [] and got["inode"]["ino"] == got["ino"]
        finally:
            cli.close()
    finally:
        node.stop()
