"""The port's geo-replication (``cubefs_tpu_torch/utils/georepl.py`` and
``fs/georepl.py``, over the metanode's and ``utils/fsm.py``'s geo hooks)
held against the reference's on the CPU.

- every scenario of the reference's ``tests/test_georepl.py`` runs on the
  port (``port_copy``), the seeded blackout drill included. Its CLI view,
  ``test_status_and_cli_geo_view``, reads the port's ``/metrics`` text
  with the port's ``cli._geo_view`` (``tests/test_torch_operators.py``
  holds each view against the reference's on the same text);
- a ship batch made by either package's ``GeoShipper`` is the same bytes
  and is applied by the other's ``GeoApplier`` to the same digest; a
  partition snapshot served by either package's gateway over the packet
  mux bootstraps the other's follower to the same digest;
- ``CUBEFS_GEO`` flipped: both packages refuse a gateway when it is off
  and leave a partition's digest what it would be without geo; on, the
  same records shipped give the same digests on both sides of both.

Tolerance: exact equality.
"""

import types

import pytest

from cubefs_tpu_torch.fs import georepl as port_fsgeo
from cubefs_tpu_torch.fs import metanode as port_mn
from cubefs_tpu_torch.utils import faultinject as fi
from cubefs_tpu_torch.utils import georepl as port_geo
from cubefs_tpu_torch.utils import rpc as port_rpc
from cubefs_tpu_torch.utils.retry import FakeClock
from test_torch_raft import cases, port_copy, run_scenario


GEOREPL = port_copy("test_georepl")


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    assert port_rpc._fault is None, "a previous test leaked an installed plan"
    yield
    fi.uninstall()


@pytest.fixture(autouse=True)
def _geo_on(monkeypatch):
    monkeypatch.setenv("CUBEFS_GEO", "1")


@pytest.mark.parametrize("name,params", cases(GEOREPL))
def test_reference_georepl_scenario_on_the_port(name, params, request):
    run_scenario(GEOREPL, name, request, params)


# ---------------- the two packages, side by side ----------------

@pytest.fixture(scope="module")
def pkgs():
    from cubefs_tpu.fs import georepl as ref_fsgeo
    from cubefs_tpu.fs import metanode as ref_mn
    from cubefs_tpu.utils import georepl as ref_geo
    from cubefs_tpu.utils import retry as ref_retry
    from cubefs_tpu.utils import rpc as ref_rpc

    return {"ref": types.SimpleNamespace(fsgeo=ref_fsgeo, mn=ref_mn, geo=ref_geo,
                                         rpc=ref_rpc, clock=ref_retry.FakeClock),
            "port": types.SimpleNamespace(fsgeo=port_fsgeo, mn=port_mn, geo=port_geo,
                                          rpc=port_rpc, clock=FakeClock)}


def _records(n, base=300, target="n" * 32):
    return [{"op": "mk_inode", "ino": base + i, "type": port_mn.FILE, "mode": 0o644,
             "target": target, "ts": float(base + i), "op_id": f"mk-{base + i}"}
            for i in range(n)]


def _region(pkg, role, name, pool=None):
    """One single-partition region of ``pkg``: a standalone partition and
    its gateway (``_pair`` of ``tests/test_georepl.py``)."""
    pool = pool or pkg.rpc.NodePool()
    mp = pkg.mn.MetaPartition(1, 100, 10**6)
    gw = pkg.fsgeo.GeoGateway(name, pool, f"geo-{name}", role=role, clock=pkg.clock())
    gw.attach_metanode(types.SimpleNamespace(partitions={1: mp}, rafts={}),
                       primaries={1: "mn-r1"})
    return mp, gw


@pytest.mark.parametrize("shipper", ["ref", "port"])
def test_ship_batch_applies_in_the_other_package(pkgs, shipper):
    """The same records committed on each package's primary give the same
    framed ship lines (stamped on equal fake clocks), and the lines of
    one package's shipper, fed to the other's follower gateway, converge
    it to the primary's digest; the stream then goes on across a gap
    healed from the shipper's ring."""
    applier = "port" if shipper == "ref" else "ref"
    lines = {}
    for side, pkg in pkgs.items():
        mp, gw = _region(pkg, "primary", f"p-{side}")
        for rec in _records(64):
            mp.submit(dict(rec))
        lines[side] = gw._parts["mp:1"].shipper.pending(1000)
        if side == shipper:
            prim, prim_gw = mp, gw
    assert lines["ref"] == lines["port"] and len(lines["port"]) == 64
    a = pkgs[applier]
    fmp, fgw = _region(a, "follower", "f")
    out = fgw.rpc_geo_ship({"part": "mp:1", "lines": lines[shipper][:40]}, b"")
    assert out["applied_seq"] == 40 and out["need"] is None
    out = fgw.rpc_geo_ship({"part": "mp:1", "lines": lines[shipper][50:]}, b"")
    assert out["need"] == 41 and out["applied_seq"] == 40
    fill = prim_gw._parts["mp:1"].shipper.backfill(out["need"])
    assert fgw.rpc_geo_ship({"part": "mp:1", "lines": fill}, b"")["applied_seq"] == 64
    assert a.geo.fsm_digest(fmp) == pkgs[shipper].geo.fsm_digest(prim)
    assert fmp.state_bytes() == prim.state_bytes()
    with pytest.raises(a.rpc.RpcError) as e:
        fmp.submit(dict(_records(1, base=9000)[0]))
    assert e.value.code == 452


@pytest.mark.parametrize("server", ["ref", "port"])
def test_snapshot_over_the_mux_bootstraps_the_other_package(pkgs, server, monkeypatch):
    """A multi-chunk partition image served by one package's gateway over
    ``OP_GEO_SNAPSHOT`` (chunk size forced low, so the image is a real
    FLAG_MORE train) bootstraps the other package's follower: equal
    digests, the sequence adopted, and a shipped record after it lands."""
    monkeypatch.setenv("CUBEFS_PKT_CHUNK", "4096")
    follower = "port" if server == "ref" else "ref"
    smp, sgw = _region(pkgs[server], "primary", "s")
    fmp, fgw = _region(pkgs[follower], "follower", "f")
    for rec in _records(160, target="n" * 64):
        smp.submit(dict(rec))
    srv = sgw.serve_packets()
    try:
        assert len(smp.state_bytes()) > 3 * 4096
        out = fgw.rpc_geo_resync({"part": "mp:1", "packet_addr": srv.addr}, b"")
        assert out["applied_seq"] == 160
        assert fmp.state_bytes() == smp.state_bytes()
        smp.submit(dict(_records(1, base=5000)[0]))
        got = fgw.rpc_geo_ship({"part": "mp:1",
                                "lines": sgw._parts["mp:1"].shipper.backfill(161)}, b"")
        assert got["applied_seq"] == 161 and 5000 in fmp.inodes
        assert pkgs[follower].geo.fsm_digest(fmp) == pkgs[server].geo.fsm_digest(smp)
    finally:
        fgw.close()
        sgw.close()


@pytest.mark.parametrize("flag", ["0", "1", ""])
def test_switch_geo_flipped_in_both_packages(pkgs, monkeypatch, flag):
    """``CUBEFS_GEO`` read the same way by both packages: off (``0`` or
    empty) both refuse a gateway and a partition's digest is the plain
    one; on, both ship the same records to the same digests."""
    monkeypatch.setenv("CUBEFS_GEO", flag)
    got = {}
    for side, pkg in pkgs.items():
        plain = pkg.mn.MetaPartition(1, 100, 10**6)
        for rec in _records(8):
            plain.submit(dict(rec))
        out = {"enabled": pkg.geo.enabled(), "plain": pkg.geo.fsm_digest(plain)}
        if not pkg.geo.enabled():
            with pytest.raises(RuntimeError, match="CUBEFS_GEO"):
                pkg.fsgeo.GeoGateway("r1", pkg.rpc.NodePool(), "geo-r1")
        else:
            pool = pkg.rpc.NodePool()
            pmp, pgw = _region(pkg, "primary", "r1", pool)
            fmp, fgw = _region(pkg, "follower", "r2", pool)
            pgw.peer_addr = "geo-r2"
            for rec in _records(8):
                pmp.submit(dict(rec))
            out["pump"] = pgw.pump()
            out["digests"] = (pkg.geo.fsm_digest(pmp), pkg.geo.fsm_digest(fmp))
        got[side] = out
    assert got["port"] == got["ref"]
    assert got["port"]["enabled"] == (flag == "1")
    if flag == "1":
        assert got["port"]["digests"] == (got["port"]["plain"],) * 2
