"""The port's typed clients (``cubefs_tpu_torch/sdk/clients.py``) held
against the reference's (``cubefs_tpu/sdk/clients.py``) on the CPU:

- every scenario of ``tests/test_sdk.py`` and ``tests/test_cm_managers.py``
  runs on the port (``port_copy``): the master's, scheduler's,
  clustermgr's, metanode's, authnode's, flash and console clients and the
  embedded blob client, with the clustermgr's config, KV and scope
  managers over raft on real HTTP;
- each package's ``WireClient`` against each package's metanode packet
  plane: ``submit_batched``, ``submit_many`` and ``pipeline`` give the
  same per-record results on all four pairs, an ``EEXIST`` among them;
- the port's remote cache, metanode and geo gateway reach their peers
  through the SDK's ``FlashClient`` and ``WireClient``.

Tolerance: exact.
"""

import functools
import importlib
import inspect

import pytest

from cubefs_tpu_torch.blob.access import AccessConfig
from cubefs_tpu_torch.blob.blobnode import BlobNode
from cubefs_tpu_torch.blob.scheduler import Scheduler
from cubefs_tpu_torch.sdk import clients
from test_torch_fs import run_in
from test_torch_raft import port_copy, scenarios

CPU = {"BlobNode": functools.partial(BlobNode, device="cpu"),
       "AccessConfig": functools.partial(AccessConfig, engine="numpy", device="cpu"),
       "Scheduler": functools.partial(Scheduler, device="cpu")}
MODULES = {"test_sdk": port_copy("test_sdk", **CPU),
           "test_cm_managers": port_copy("test_cm_managers")}
CASES = [(m, n) for m, mod in MODULES.items() for n in scenarios(mod)]


@pytest.mark.parametrize("module,name", CASES)
def test_reference_sdk_scenario_on_the_port(module, name, request):
    run_in(MODULES[module], name, request)


def test_every_scenario_runs_and_every_client_is_ported():
    assert len(CASES) == 8 + 4
    from cubefs_tpu.sdk import clients as ref_clients

    def surface(mod):
        return {name: sorted(n for n in vars(cls) if not n.startswith("__"))
                for name, cls in vars(mod).items()
                if inspect.isclass(cls) and cls.__module__ == mod.__name__}

    assert surface(clients) == surface(ref_clients)
    assert len(surface(clients)) == 12  # the eleven clients and their base


def test_port_planes_reach_their_peers_through_the_sdk():
    """No private stand-in is left: the flash read tier, the metanode's
    range fetch and the geo gateway's snapshot pull use the SDK."""
    from cubefs_tpu_torch.fs import georepl, metanode, remotecache

    assert not hasattr(remotecache, "_FlashClient")
    for mod in (metanode, georepl):
        src = inspect.getsource(mod)
        assert "WireClient(addr)" in src and "PacketClient(addr" not in src
    assert "FlashClient(self.nodes.get(addr))" in inspect.getsource(remotecache)


# ---------------- each WireClient against each metanode packet plane ----------------

def _packet_metanode(pkg: str, root):
    mod = importlib.import_module(f"{pkg}.fs.metanode")
    rpc = importlib.import_module(f"{pkg}.utils.rpc")
    node = mod.MetaNode(0, addr="m0", node_pool=rpc.NodePool(), data_dir=str(root / pkg))
    node.create_partition(3, 1, 1 << 20, peers=["m0"])
    return node, node.serve_packets()


@pytest.fixture
def planes(tmp_path):
    made = {pkg: _packet_metanode(mod, tmp_path)
            for pkg, mod in (("port", "cubefs_tpu_torch"), ("ref", "cubefs_tpu"))}
    yield {pkg: psrv.addr for pkg, (_, psrv) in made.items()}
    for node, psrv in made.values():
        psrv.stop()
        node.stop()


def _rec(top, name, i):
    return {"op": "mknod", "parent": 1, "name": f"{top}-{name}", "type": "file",
            "mode": 0o644, "ts": 1.0, "op_id": f"{top}-op-{i}"}


def _drive(wire_cls, pkt, addr, top):
    """The three pumps on one connection, window 1 so that inode numbers
    are handed out in submission order."""
    wc = wire_cls(addr, window=1)
    try:
        names = [f"b{i}" for i in range(10)] + ["b3"]  # the last one exists: EEXIST
        batched = wc.submit_batched(3, [_rec(top, n, i) for i, n in enumerate(names)], batch=4)
        many = wc.submit_many(3, [_rec(top, f"m{i}", 100 + i) for i in range(5)])
        piped = wc.pipeline([{"opcode": pkt.OP_META_SUBMIT,
                              "args": {"pid": 3, "record": _rec(top, "b0", 200)},
                              "idempotent": True},
                             {"opcode": pkt.OP_PING}])
        ping = wc.ping()
    finally:
        wc.close()
    return batched, many, piped, ping


def _normal(x, base, top):
    """Inode numbers as offsets from the first one each pair handed out,
    and the pair's name prefix taken out of error messages."""
    if isinstance(x, dict):
        return {k: (v - base if k == "ino" and isinstance(v, int) else _normal(v, base, top))
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_normal(v, base, top) for v in x]
    if isinstance(x, (Exception, str)):
        return (type(x).__name__, str(x).replace(top, "<top>"))
    return x


def test_each_wire_client_against_each_metanode(planes):
    from cubefs_tpu.sdk import clients as ref_clients
    from cubefs_tpu.utils import packet as ref_packet

    from cubefs_tpu_torch.utils import packet

    got = {}
    for cname, wire_cls, pkt in (("port", clients.WireClient, packet),
                                 ("ref", ref_clients.WireClient, ref_packet)):
        for sname, addr in planes.items():
            batched, many, piped, ping = _drive(wire_cls, pkt, addr, f"{cname}")
            base = batched[0][0]["ino"]
            got[cname, sname] = _normal([batched, many, [p[0] if isinstance(p, tuple) else p
                                                          for p in piped]], base, cname)
            got[cname, sname].append(sorted(ping))
    first = got["port", "port"]
    assert all(v == first for v in got.values()), got
    batched = first[0]
    assert len(batched) == 11 and all(r[1] is None for r in batched[:10])
    assert batched[10][0] is None and batched[10][1][0] == 17  # EEXIST, per record
