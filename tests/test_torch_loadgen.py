"""The port's traffic model (``cubefs_tpu_torch/tool/loadgen.py``) held
against the reference's on the CPU.

- every scenario of the reference's ``tests/test_loadgen.py`` runs on the
  port (``port_copy``);
- the same seed gives both packages the same schedule digest and the same
  facts: ``scale_run``, ``noisy_neighbor_leg`` with the gate on and off,
  ``qos_ab``, and the wire mode's planned op streams (``_plan_digest``);
- the wire mode forks its server and workers, pins each to a core and
  reads their CPU time: a short leg on the port carries both tenants'
  frames and plans the reference's digest; ``check_host`` answers, and
  a refused ``sched_setaffinity`` fails the run loudly;
- the module imports nothing that initialises CUDA (the parent forks).

Tolerance: exact equality.
"""

import hashlib
import json
import os
import subprocess
import sys

import pytest

from cubefs_tpu_torch.tool import loadgen
from test_torch_raft import port_copy, run_scenario, scenarios

LOADGEN = port_copy("test_loadgen")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ref_loadgen():
    from cubefs_tpu.tool import loadgen as ref

    return ref


@pytest.mark.parametrize("name", scenarios(LOADGEN))
def test_reference_loadgen_scenario_on_the_port(name, request):
    run_scenario(LOADGEN, name, request)


def test_every_loadgen_scenario_runs():
    assert len(scenarios(LOADGEN)) == 8


@pytest.mark.parametrize("seed", [7, 11])
def test_scale_run_equals_the_references(seed, ref_loadgen):
    kw = dict(clients=20_000, seed=seed, max_events=30_000, duration_s=3.0)
    port, ref = loadgen.scale_run(**kw), ref_loadgen.scale_run(**kw)
    assert port == ref and port["events"] > 20_000


@pytest.mark.parametrize("qos_on", [True, False], ids=["qos_on", "qos_off"])
def test_noisy_neighbor_leg_equals_the_references(qos_on, ref_loadgen):
    kw = dict(victim_clients=100, bully_clients=400, duration_s=8.0)
    port = loadgen.noisy_neighbor_leg(29, qos_on, **kw)
    assert port == ref_loadgen.noisy_neighbor_leg(29, qos_on, **kw)
    assert port["events"] > 1000


def test_qos_ab_equals_the_references_and_writes_only_where_asked(ref_loadgen, tmp_path,
                                                                  monkeypatch):
    leg = loadgen.noisy_neighbor_leg

    def short(fn):
        return lambda seed, on: fn(seed, on, victim_clients=100, bully_clients=400,
                                   duration_s=6.0)

    monkeypatch.setattr(loadgen, "noisy_neighbor_leg", short(leg))
    monkeypatch.setattr(ref_loadgen, "noisy_neighbor_leg", short(ref_loadgen.noisy_neighbor_leg))
    monkeypatch.chdir(tmp_path)
    port = loadgen.qos_ab(seed=12)
    assert list(tmp_path.iterdir()) == []
    out = tmp_path / "qos.json"
    assert port == ref_loadgen.qos_ab(seed=12) == loadgen.qos_ab(seed=12, out=str(out))
    assert out.exists() and port["reproducible"]


def test_wire_plan_digest_equals_the_references(ref_loadgen):
    specs = [loadgen.TenantSpec("victim", 3, read_fraction=1.0),
             loadgen.TenantSpec("bully", 4, read_fraction=0.0)]
    ref_specs = [ref_loadgen.TenantSpec(*s) for s in specs]
    clients = [(0, 0), (2, 0), (4, 1), (6, 1)]
    for widx in range(3):
        assert (loadgen._plan_digest(17, widx, clients, specs)
                == ref_loadgen._plan_digest(17, widx, clients, ref_specs))


def test_wire_leg_forks_pins_and_plans_the_references_digest(ref_loadgen):
    """A one-second leg, in a fresh interpreter as its command line runs
    (it forks: a test worker's threads must not be copied into the
    children): the server and 2 workers forked and pinned, both tenants'
    frames served, the combined planned digest the reference's for the
    same seed and client split."""
    code = ("import json\nfrom cubefs_tpu_torch.tool import loadgen\n"
            "print(json.dumps(loadgen.wire_brownout_leg(17, True, duration_s=1.0, workers=2, "
            "victim_clients=4, bully_clients=6)))\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    leg = json.loads(run.stdout)
    assert leg["workers"] == 2 and leg["victim"]["reads"] > 0
    assert leg["bully"]["issued"] + leg["bully"]["shed"] > 0
    assert leg["server"]["issued"] > 0 and leg["server_cpu_s"] > 0
    assert all(c > 0 for c in leg["worker_cpu_s"])
    assert leg["victim"]["errors"] == leg["bully"]["errors"] == 0
    specs = [ref_loadgen.TenantSpec("victim", 4, think_s=0.15, read_fraction=1.0,
                                    get_cost=1.0),
             ref_loadgen.TenantSpec("bully", 6, think_s=0.02, read_fraction=0.0,
                                    put_cost=16.0, open_fraction=0.3)]
    assign = [[], []]
    for cid in range(10):
        assign[cid % 2].append((cid, 0 if cid < 4 else 1))
    digests = sorted(ref_loadgen._plan_digest(17, w, assign[w], specs) for w in range(2))
    assert leg["digest"] == hashlib.sha256("".join(digests).encode()).hexdigest()


def test_check_host_answers_and_a_refused_pin_fails_loudly(monkeypatch):
    before = os.sched_getaffinity(0)
    got = loadgen.check_host()
    assert os.sched_getaffinity(0) == before
    assert got["pinned"] in got["cores"] and got["rusage_cpu_s"] > 0

    def refuse(pid, cores):
        raise OSError(22, "Invalid argument")

    monkeypatch.setattr(os, "sched_setaffinity", refuse)
    with pytest.raises(RuntimeError, match="sched_setaffinity"):
        loadgen._pin_to_core(0)


def test_check_host_burns_until_a_coarse_cpu_clock_ticks(monkeypatch):
    """A host that counts CPU time in 10 ms ticks reads no time after a
    short burn: the probe burns on until a tick lands, and fails only if
    none does within its deadline."""
    reads = iter([0.0] * 6 + [0.01] * 100)
    monkeypatch.setattr(loadgen, "_cpu_seconds", lambda: next(reads))
    assert loadgen.check_host()["rusage_cpu_s"] == 0.01
    monkeypatch.setattr(loadgen, "_cpu_seconds", lambda: 0.0)
    monkeypatch.setattr(loadgen, "CHECK_HOST_DEADLINE_S", 0.05)
    with pytest.raises(RuntimeError, match="RUSAGE_SELF reads no CPU time"):
        loadgen.check_host()


def test_the_module_initialises_no_cuda():
    code = ("import sys\nimport cubefs_tpu_torch.tool.loadgen\n"
            "assert 'torch' not in sys.modules, 'loadgen imported torch'\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=60)
