"""The blob roles over HTTP on the card: the launcher's processes
(``deploy.Cluster``: a clustermgr, 4 blobnodes x 3 disks and access under
``cuda``), driven over the wire. Kernel A launches in the access role's
own process, counted from its ``/metrics``: once for a PUT's stack, and
at least once per blob that lost a data unit when a blobnode process is
stopped; every read equals what was written.

Every test needs a CUDA device (``cuda`` marker; the fixture skips
without one). The file imports no jax:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_roles_card.py

Tolerance: exact equality.
"""

import http.client
import json

import numpy as np
import pytest
import torch

from cubefs_tpu_torch.codec import codemode as tcm
from cubefs_tpu_torch.deploy.cluster import Cluster

BLOB = 1 << 20
LAUNCHES = 'cubefs_codec_kernel_launches_total{kernel="gf_apply"}'


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def post(addr: str, method: str, args: dict, body: bytes = b""):
    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=300)
    try:
        conn.request("POST", f"/{method}", body=body, headers={"X-Rpc-Args": json.dumps(args)})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.headers.get("X-Rpc-Resp") or "{}"), resp.read()
    finally:
        conn.close()


def launches(addr: str) -> float:
    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
    finally:
        conn.close()
    return sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines() if ln.startswith(LAUNCHES))


@pytest.mark.cuda
def test_access_role_launches_a_for_put_and_degraded_get(cuda_device, tmp_path):
    c = Cluster({"blobnodes": 4, "disks_per_blobnode": 3, "blob_size": BLOB,
                 "ec_engine": "cuda"}, str(tmp_path), timeout=300.0)
    try:
        roles = c.up()["roles"]
        acc, cm = roles["access"][0], roles["clustermgr"][0]
        data = np.random.default_rng(11).integers(0, 256, 3 * BLOB + 5, np.uint8).tobytes()
        a0 = launches(acc)
        st, meta, _ = post(acc, "put", {"codemode": int(tcm.CodeMode.EC6P3)}, data)
        assert st == 200
        assert launches(acc) - a0 == 1  # one A step for the PUT's stack
        loc = meta["location"]
        assert post(acc, "get", {"location": loc})[2] == data

        t = tcm.tactic(tcm.CodeMode.EC6P3)
        sl = loc["slices"][0]
        units = post(cm, "get_volume", {"vid": sl["vid"]})[1]["volume"]["units"]
        held = {p.addr: [u["index"] for u in units if u["node_addr"] == p.addr]
                for p in c.procs if p.role == "blobnode"}
        victim = max((a for a, ix in held.items() if len(ix) <= t.m and
                      any(i < t.n for i in ix)), key=lambda a: len(held[a]))
        proc = next(p for p in c.procs if p.addr == victim)
        proc.p.terminate()
        assert proc.p.wait(60) == 0
        a1 = launches(acc)
        assert post(acc, "get", {"location": loc})[2] == data
        assert launches(acc) - a1 >= sl["count"]  # every blob lost a data unit
    finally:
        codes = c.down()
    assert all(rc == 0 for rc in codes.values()), codes
