"""The port's codec admission layer (``cubefs_tpu_torch/codec/batcher.py``):
bit-identity of coalesced steps with the unbatched engine, coalescing,
per-submission error fan-back, backpressure, the CUBEFS_CODEC_BATCH
door, step-size bounds, the AdmittedEngine facade, the encoders'
``encode_async``, zero-copy single-submission steps and, on the card,
the stream rule. The counterparts of ``tests/test_codec_batch.py``
(without its dp and metrics cases). Then the host engines and ``auto``:
numpy submissions coalescing per geometry, steps counted under the leg
that served, the XOR door and the drill, and the encoders on host
stripes held against the reference's encoder of the same engine.

Every test of the batcher builds a private BatchCodec, so nothing leaks
into the process-wide DEFAULT. The file imports no jax at module level
(the reference's encoder is imported by the ``ref_codec`` fixture): its
``cuda`` tests run on a machine with only the port's dependencies:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_batcher.py

Numpy-seeded inputs; tolerance: exact equality.
"""

import threading

import numpy as np
import pytest
import torch

from cubefs_tpu_torch.codec import batcher as B
from cubefs_tpu_torch.codec import codemode as tcm
from cubefs_tpu_torch.codec.batcher import (AdmittedEngine, BackpressureError, BatchCodec,
                                            CodecAdmissionError, admit)
from cubefs_tpu_torch.codec.encoder import CodecConfig, new_encoder
from cubefs_tpu_torch.codec.engine import CudaEngine
from cubefs_tpu_torch.ops import _build

CPU = CudaEngine("cpu")  # the unbatched engine every result is held against
ROWS = np.ascontiguousarray(np.arange(1, 13, dtype=np.uint8).reshape(2, 6))


class _BlockingCodec(BatchCodec):
    """Device step parks on an event, so a test can hold a drain in
    flight while it probes admission."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.entered = threading.Event()
        self.release = threading.Event()

    def _engine_call(self, key, eng, coeff, arr, out):
        self.entered.set()
        assert self.release.wait(30.0)
        return super()._engine_call(key, eng, coeff, arr, out)


class _RecordingCodec(BatchCodec):
    """Keeps the tensors each device step was handed."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.calls = []

    def _engine_call(self, key, eng, coeff, arr, out):
        self.calls.append((arr, out))
        return super()._engine_call(key, eng, coeff, arr, out)


def _stripes(seed, b, n, s, device="cpu"):
    x = np.random.default_rng(seed).integers(0, 256, (b, n, s), dtype=np.uint8)
    return torch.from_numpy(x).to(device)


# ---------------- bit-identity ----------------

def test_concurrent_submits_bit_identical():
    """32 submitters race one BatchCodec; every result equals the
    unbatched engine's byte for byte."""
    bc = BatchCodec(enabled=True)
    n, m, s = 6, 3, 128
    inputs = [_stripes(i, 2, n, s) for i in range(32)]
    golden_enc = [CPU.encode_parity(d, m) for d in inputs]
    golden_app = [CPU.matrix_apply(ROWS, d) for d in inputs]
    outs = {}
    start = threading.Barrier(32)

    def submitter(tid):
        start.wait()
        d = inputs[tid]
        if tid % 2 == 0:
            outs[tid] = bc.submit_encode("cpu", d, m)
        else:
            outs[tid] = bc.submit_apply("cpu", ROWS, d)

    threads = [threading.Thread(target=submitter, args=(i,)) for i in range(32)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    assert not any(t.is_alive() for t in threads)
    for tid in range(32):
        want = golden_enc[tid] if tid % 2 == 0 else golden_app[tid]
        assert torch.equal(outs[tid], want), f"submitter {tid}"
    assert bc.submissions == 32 and 2 <= bc.steps <= 32


def test_async_pipeline_coalesces_into_one_step():
    """Pipelined async submissions park until the first collector drains
    them: 10 submissions, ONE device step, views of one output."""
    bc = BatchCodec(enabled=True)
    n, m, s = 4, 2, 64
    inputs = [_stripes(i, 3, n, s) for i in range(10)]
    futs = [bc.submit_encode_async("cpu", d, m) for d in inputs]
    assert bc.steps == 0  # nothing drained yet: all parked
    outs = [f.result() for f in futs]
    assert (bc.steps, bc.submissions) == (1, 10)
    for d, out in zip(inputs, outs):
        assert torch.equal(out, CPU.encode_parity(d, m))
    assert outs[1].data_ptr() == outs[0].data_ptr() + outs[0].numel()  # one output
    assert torch.equal(futs[0].result(), outs[0])  # collecting again is idempotent


def test_idle_queues_are_dropped():
    """A drained key's queue goes: a process that sees many payload sizes
    and erasure patterns keeps no queue for any of them once idle, and a
    key seen again gets a new one."""
    bc = BatchCodec(enabled=True)
    rng = np.random.default_rng(5)
    for s in (32, 33, 64, 100, 32):
        futs = [bc.submit_encode_async("cpu", _stripes(s + i, 1, 4, s), 2) for i in range(3)]
        futs.append(bc.submit_apply_async("cpu", rng.integers(0, 256, (2, 6), dtype=np.uint8),
                                          _stripes(s, 1, 6, s)))
        assert len(bc._queues) == 2
        for f in futs:
            f.result()
        assert len(bc._queues) == 0
    assert bc.submissions == 20 and bc.steps == 10


def test_mixed_geometry_does_not_coalesce():
    """Different keys never share a device step."""
    bc = BatchCodec(enabled=True)
    a = bc.submit_encode_async("cpu", _stripes(1, 1, 4, 64), 2)
    b = bc.submit_encode_async("cpu", _stripes(2, 1, 6, 64), 3)
    c = bc.submit_apply_async("cpu", ROWS, _stripes(3, 1, 6, 64))
    d = bc.submit_apply_async("cpu", ROWS[:1], _stripes(4, 1, 6, 64))
    for f in (a, b, c, d):
        f.result()
    assert bc.steps == 4


# ---------------- zero copy ----------------

def test_single_submission_step_passes_the_callers_tensors():
    """A step of one submission hands the engine the submitted tensor and
    its out= view: no concatenation, no copy, parity in the stripe."""
    bc = _RecordingCodec(enabled=True)
    stripes = torch.zeros((2, 9, 256), dtype=torch.uint8)
    stripes[:, :6] = _stripes(5, 2, 6, 256)
    data, parity = stripes[:, :6], stripes[:, 6:]
    assert bc.submit_encode("cpu", data, 3, out=parity) is parity
    ((arr, out),) = bc.calls
    assert arr is data and out is parity
    assert torch.equal(parity, CPU.encode_parity(data, 3))


def test_coalesced_step_copies_into_each_out():
    bc = BatchCodec(enabled=True)
    stripes = [torch.zeros((1, 9, 128), dtype=torch.uint8) for _ in range(3)]
    for i, st in enumerate(stripes):
        st[:, :6] = _stripes(10 + i, 1, 6, 128)
    futs = [bc.submit_encode_async("cpu", st[:, :6], 3, out=st[:, 6:]) for st in stripes]
    futs.append(bc.submit_encode_async("cpu", _stripes(9, 2, 6, 128), 3))
    for st, f in zip(stripes, futs):
        assert f.result() is f.out
        assert torch.equal(st[:, 6:], CPU.encode_parity(st[:, :6], 3))
    assert torch.equal(futs[3].result(), CPU.encode_parity(_stripes(9, 2, 6, 128), 3))
    assert bc.steps == 1


# ---------------- error fan-back ----------------

def test_midbatch_bad_submission_fails_alone():
    """A malformed submission inside a drained batch is rejected back to
    exactly its submitter; batch-mates proceed bit-identically."""
    bc = BatchCodec(enabled=True)
    n, m, s = 5, 2, 96
    good = [_stripes(i, 2, n, s) for i in range(8)]
    futs = [bc.submit_encode_async("cpu", d, m) for d in good[:4]]
    bad = bc.submit_encode_async("cpu", torch.rand((2, n, s)), m)
    futs += [bc.submit_encode_async("cpu", d, m) for d in good[4:]]
    with pytest.raises(CodecAdmissionError, match="uint8"):
        bad.result()
    for d, f in zip(good, futs):
        assert torch.equal(f.result(), CPU.encode_parity(d, m))
    with pytest.raises(CodecAdmissionError):  # the error is sticky
        bad.result()


def test_engine_failure_fans_back_to_whole_step():
    class _Dying(BatchCodec):
        def _engine_call(self, key, eng, coeff, arr, out):
            raise RuntimeError("device lost mid step")

    bc = _Dying(enabled=True)
    futs = [bc.submit_encode_async("cpu", _stripes(i, 1, 4, 32), 2) for i in range(3)]
    for f in futs:
        with pytest.raises(RuntimeError, match="device lost"):
            f.result()
    # the failed step still reopens its key: the queue is dropped idle
    assert futs[0]._key not in bc._queues and bc._n_busy == 0 and bc._pending == 0


def test_dying_drainer_fails_parked_submissions_and_reraises():
    class _Interrupted(BatchCodec):
        def _run_steps(self, key, q, batch):
            q.subs.append(orphan)  # parked behind the swap being run
            raise KeyboardInterrupt

    bc = _Interrupted(enabled=True)
    first = bc.submit_encode_async("cpu", _stripes(1, 1, 4, 32), 2)
    orphan = B.CodecFuture(bc, first._key, _stripes(2, 1, 4, 32), None)
    bc._pending += 1
    with pytest.raises(KeyboardInterrupt):
        first.result()
    with pytest.raises(CodecAdmissionError, match="drainer died"):
        orphan.result()
    assert first._key not in bc._queues and bc._n_busy == 0 and bc._pending == 0


# ---------------- backpressure ----------------

def test_backpressure_bounds_pending_stripes():
    bc = _BlockingCodec(enabled=True, max_pending=4)
    first = bc.submit_encode_async("cpu", _stripes(1, 4, 4, 32), 2)
    collector = threading.Thread(target=first.result)
    collector.start()
    assert bc.entered.wait(10.0)  # drain in flight, 4 stripes pending
    with pytest.raises(BackpressureError):
        bc.submit_encode_async("cpu", _stripes(2, 2, 4, 32), 2, timeout=0.15)
    bc.release.set()
    collector.join(timeout=30.0)
    assert not collector.is_alive()
    # once the drain lands, admission reopens
    assert bc.submit_encode("cpu", _stripes(3, 2, 4, 32), 2).shape == (2, 2, 32)


def test_idle_submitter_never_parks_itself():
    """A lone submitter over the bound proceeds: it is the drainer."""
    bc = BatchCodec(enabled=True, max_pending=1)
    assert bc.submit_encode("cpu", _stripes(1, 4, 4, 32), 2).shape == (4, 2, 32)


# ---------------- the door ----------------

def test_disabled_door_bypasses_queues():
    bc = _RecordingCodec(enabled=False)
    d = _stripes(1, 2, 4, 64)
    out = bc.submit_encode("cpu", d, 2)
    assert torch.equal(out, CPU.encode_parity(d, 2))
    fut = bc.submit_encode_async("cpu", d, 2)
    assert fut.done  # resolved inline: nothing parked
    assert torch.equal(fut.result(), out)
    assert len(bc.calls) == 2 and not bc._queues and bc.steps == 0
    bad = bc.submit_encode_async("cpu", torch.rand((1, 4, 64)), 2)
    with pytest.raises(ValueError, match="uint8"):
        bad.result()


def test_env_knobs(monkeypatch):
    monkeypatch.setenv("CUBEFS_CODEC_BATCH", "0")
    assert BatchCodec().enabled is False
    monkeypatch.setenv("CUBEFS_CODEC_BATCH", "1")
    monkeypatch.setenv("CUBEFS_CODEC_BATCH_MAX", "7")
    monkeypatch.setenv("CUBEFS_CODEC_BATCH_WAIT_MS", "2.5")
    monkeypatch.setenv("CUBEFS_CODEC_BATCH_PENDING", "not-a-number")
    monkeypatch.setenv("CUBEFS_CODEC_STEP_BYTES", "1024")
    bc = BatchCodec()
    assert (bc.enabled, bc.max_batch, bc.max_wait, bc.max_pending, bc.max_step_bytes) == (
        True, 7, 0.0025, 4096, 1024)


# ---------------- step-size bounds ----------------

def test_max_batch_splits_steps():
    bc = BatchCodec(enabled=True, max_batch=4)
    futs = [bc.submit_encode_async("cpu", _stripes(i, 3, 4, 32), 2) for i in range(3)]
    for f in futs:
        f.result()
    # 9 stripes, cap 4, whole submissions only: 3+3 > 4 -> three steps
    assert bc.steps == 3


def test_max_step_bytes_splits_steps():
    n, s = 4, 64
    bc = BatchCodec(enabled=True, max_step_bytes=2 * n * s)  # two stripes of input
    futs = [bc.submit_encode_async("cpu", _stripes(i, 2, n, s), 2) for i in range(4)]
    for f in futs:
        f.result()
    assert bc.steps == 4


def test_linger_still_coalesces():
    bc = BatchCodec(enabled=True, max_wait_ms=1.0)
    futs = [bc.submit_apply_async("cpu", ROWS, _stripes(i, 1, 6, 32)) for i in range(5)]
    for i, f in enumerate(futs):
        assert torch.equal(f.result(), CPU.matrix_apply(ROWS, _stripes(i, 1, 6, 32)))
    assert bc.steps == 1


# ---------------- AdmittedEngine facade ----------------

def test_admitted_engine_shapes():
    eng = AdmittedEngine(BatchCodec(enabled=True), "cpu")
    d2 = _stripes(1, 1, 6, 32)[0]
    assert torch.equal(eng.encode_parity(d2, 3), CPU.encode_parity(d2, 3))
    assert torch.equal(eng.matrix_apply(ROWS, d2), CPU.matrix_apply(ROWS, d2))
    d3 = _stripes(2, 4, 6, 32)
    assert torch.equal(eng.encode_parity(d3, 3), CPU.encode_parity(d3, 3))
    d4 = _stripes(3, 6, 6, 32).view(2, 3, 6, 32)
    out = eng.encode_parity(d4, 3)
    assert out.shape == (2, 3, 3, 32)
    assert torch.equal(out.view(6, 3, 32), CPU.encode_parity(d4.reshape(6, 6, 32), 3))
    stripes = torch.zeros((2, 3, 9, 32), dtype=torch.uint8)
    stripes[..., :6, :] = d4
    assert eng.encode_parity(stripes[..., :6, :], 3, out=stripes[..., 6:, :]) is not None
    assert torch.equal(stripes[..., 6:, :], out)
    with pytest.raises(ValueError):
        eng.encode_parity(torch.zeros(8, dtype=torch.uint8), 3)
    with pytest.raises(ValueError):
        eng.matrix_apply(ROWS, np.zeros((6, 32), np.uint8))


def test_admit_binds_the_default_batcher_and_device():
    eng = admit("cpu")
    assert eng.batcher is B.DEFAULT and eng.device == torch.device("cpu")
    mine = BatchCodec()
    assert admit("cpu", batcher=mine).batcher is mine
    with pytest.raises(ValueError):
        admit("meta")
    enc = new_encoder(CodecConfig(tcm.CodeMode.EC6P3, device="cpu"))
    assert isinstance(enc.engine, AdmittedEngine) and enc.engine.batcher is B.DEFAULT


def test_submit_validation():
    bc = BatchCodec(enabled=True)
    with pytest.raises(ValueError, match=r"\(B, N, S\)"):
        bc.submit_encode("cpu", torch.zeros((4, 32), dtype=torch.uint8), 2)
    with pytest.raises(ValueError, match=r"\(B, C, S\)"):
        bc.submit_apply("cpu", np.eye(4, dtype=np.uint8), torch.zeros(32, dtype=torch.uint8))
    with pytest.raises(ValueError, match=r"\(B, N, S\)"):
        bc.submit_encode("cpu", np.zeros((1, 4, 32), np.uint8), 2)
    with pytest.raises(ValueError, match="out must be"):
        bc.submit_encode("cpu", torch.zeros((1, 4, 32), dtype=torch.uint8), 2,
                         out=torch.zeros((1, 3, 32), dtype=torch.uint8))
    assert not bc._queues


# ---------------- encode_async (PendingEncode) ----------------

@pytest.mark.parametrize("mode", ["EC6P3", "EC4P4L2", "EC16P20L2", "EC4P4MSR", "EC6P6MSR"])
def test_encode_async_matches_sync(mode):
    """wait() lands the same parity rows in place that a blocking encode
    would, through a private batcher; concurrent stripes of one encoder
    coalesce into one step."""
    bc = BatchCodec(enabled=True, max_wait_ms=1.0)
    enc = new_encoder(CodecConfig(tcm.CodeMode[mode], device="cpu"))
    enc.engine = AdmittedEngine(bc, "cpu")
    s = enc.shard_size(600)
    batches = []
    for i in range(3):
        st = torch.zeros((2, enc.t.total, s), dtype=torch.uint8)
        st[:, : enc.t.n] = _stripes(i, 2, enc.t.n, s)
        batches.append(st)
    refs = [enc.encode(st.clone()) for st in batches]
    steps = bc.steps
    pendings = [enc.encode_async(st) for st in batches]
    for st, ref, p in zip(batches, refs, pendings):
        assert p.wait() is st  # parity landed into the caller's tensor
        assert torch.equal(st, ref) and p.resolved
    assert bc.steps == steps + 1
    assert enc.verify(batches[0])


def test_encode_async_disabled_door_is_inline():
    enc = new_encoder(CodecConfig(tcm.CodeMode.EC6P3, enable_verify=True, device="cpu"))
    enc.engine = AdmittedEngine(BatchCodec(enabled=False), "cpu")
    st = torch.zeros((1, enc.t.total, 32), dtype=torch.uint8)
    st[:, : enc.t.n] = _stripes(1, 1, enc.t.n, 32)
    pending = enc.encode_async(st)
    assert pending.resolved  # nothing left in flight
    assert enc.verify(pending.wait())


def test_encode_async_raises_verify_error_at_wait():
    class _Wrong(BatchCodec):
        def _engine_call(self, key, eng, coeff, arr, out):
            return out.fill_(1) if out is not None else super()._engine_call(
                key, eng, coeff, arr, out)

    enc = new_encoder(CodecConfig(tcm.CodeMode.EC6P3, enable_verify=True, device="cpu"))
    enc.engine = AdmittedEngine(_Wrong(enabled=True), "cpu")
    st = torch.zeros((1, enc.t.total, 32), dtype=torch.uint8)
    st[:, : enc.t.n] = _stripes(2, 1, enc.t.n, 32)
    from cubefs_tpu_torch.codec.encoder import VerifyError

    with pytest.raises(VerifyError):
        enc.encode_async(st).wait()


# ---------------- the step's trace span ----------------

def _step_span_tree(tracelib, metrics, submit) -> dict:
    """Three submitters, each under a ``blob.put`` root span of its own,
    park an encode of one geometry; a fourth span collects all three (its
    first collect drains them as one step). Returns the step spans with
    every span id replaced by its span's operation, how many
    ``codec_step`` stage samples the step observed and the errors its
    submissions got."""
    stage = metrics.request_stage_seconds
    before = sum(s["count"] for k, s in stage.samples() if k == ("blob.put", "codec_step"))
    tracelib.reset_collector()
    futs, errors = [], []
    for i in range(3):
        with tracelib.path_span("blob.put", f"put{i}"):
            futs.append(submit(i))
    with tracelib.path_span("blob.put", "collector"):
        for f in futs:
            try:
                f.result()
            except RuntimeError as e:
                errors.append(str(e))
    spans = tracelib.finished_spans()
    name = {sp["span_id"]: sp["op"] for sp in spans}
    steps = [{"parent": name.get(sp["parent_id"]), "tags": sp["tags"], "path": sp.get("path"),
              "follows": sorted(name[f["span_id"]] for f in sp.get("follows", []))}
             for sp in spans if sp["op"] == "stage:codec_step"]
    after = sum(s["count"] for k, s in stage.samples() if k == ("blob.put", "codec_step"))
    return {"steps": steps, "stage_samples": after - before, "errors": errors}


@pytest.mark.parametrize("fails", [False, True], ids=["step_ok", "step_fails"])
def test_coalesced_step_span_tree_equals_the_reference(fails):
    """The drained step opens one ``stage:codec_step`` span under the
    collector's span, following from every submitter, tagged with its
    stage, op and stripe count, and observes the ``codec_step`` stage:
    the same tree the reference's batcher records for the same script.
    A failing step fails each submission, tags no error on the span and
    observes no stage sample, as the reference's does."""
    from cubefs_tpu.codec import batcher as ref_batcher
    from cubefs_tpu.utils import metrics as ref_metrics
    from cubefs_tpu.utils import trace as ref_trace
    from cubefs_tpu_torch.utils import metrics, trace

    n, m, s = 4, 2, 64
    data = [np.random.default_rng(i).integers(0, 256, (i + 1, n, s), dtype=np.uint8)
            for i in range(3)]
    ref_bc, bc = ref_batcher.BatchCodec(enabled=True), BatchCodec(enabled=True)
    if fails:
        def lost(*args):
            raise RuntimeError("device lost")

        ref_bc._engine_call = bc._engine_call = lost
    want = _step_span_tree(ref_trace, ref_metrics,
                           lambda i: ref_bc.submit_encode_async("numpy", data[i], m))
    got = _step_span_tree(trace, metrics,
                          lambda i: bc.submit_encode_async("cpu", torch.from_numpy(data[i]), m))
    assert got == want
    assert got == {"steps": [{"parent": "collector", "path": "blob.put",
                              "tags": {"stage": "codec_step", "op": "encode", "stripes": 6},
                              "follows": ["put0", "put1", "put2"]}],
                   "stage_samples": 0 if fails else 1,
                   "errors": ["device lost"] * 3 if fails else []}


# ---------------- host engines and auto ----------------

@pytest.fixture
def routing(monkeypatch, tmp_path):
    """The port's engine module with a private table path, no drill and
    the XOR door open."""
    from cubefs_tpu_torch.codec import engine as E

    monkeypatch.setattr(E, "_policy_path", lambda: str(tmp_path / "CROSSOVER.json"))
    monkeypatch.setattr(E, "_policy", None)
    monkeypatch.delenv("CUBEFS_CODEC_DEAD", raising=False)
    monkeypatch.delenv("CUBEFS_CODEC_XOR", raising=False)
    monkeypatch.delenv("CUBEFS_TPU_EC_ENGINE", raising=False)
    return E


def _host_stripes(seed, b, n, s):
    return np.random.default_rng(seed).integers(0, 256, (b, n, s), dtype=np.uint8)


def _steps(engine: str) -> float:
    from cubefs_tpu_torch.utils import metrics

    return metrics.codec_batch_steps.value(op="encode", engine=engine)


@pytest.mark.parametrize("engine,served", [("auto", "cuda"), ("numpy-xor", "numpy-xor"),
                                           ("cpp", "cpp")])
def test_host_submissions_coalesce_and_count_the_served_leg(routing, engine, served):
    """Numpy submissions of one geometry park and land as ONE step on the
    leg the engine routes to; ``auto`` picks it by the coalesced step's
    bytes (each 768-byte stripe alone would go to ``cpp``, the six
    together are beyond the table and go to ``cuda``)."""
    routing._policy = [[1024, "cpp"]]
    bc = BatchCodec(enabled=True)
    inputs = [_host_stripes(i, 1, 6, 128) for i in range(6)]
    before = _steps(served)
    futs = [bc.submit_encode_async("cpu", d, 3, engine=engine) for d in inputs]
    outs = [f.result() for f in futs]
    assert (bc.steps, bc.submissions) == (1, 6)
    assert _steps(served) == before + 1
    assert routing.last_dispatch["served"] == served
    for d, out in zip(inputs, outs):
        assert isinstance(out, np.ndarray)
        assert np.array_equal(out, CPU.encode_parity(torch.from_numpy(d), 3).numpy())
    alone = bc.submit_encode("cpu", inputs[0], 3, engine=engine)
    assert np.array_equal(alone, outs[0])
    if engine == "auto":
        assert routing.last_dispatch["served"] == "cpp"


def test_host_xor_door_and_drill_label_the_step(routing, monkeypatch):
    bc = BatchCodec(enabled=True)
    d = _host_stripes(3, 2, 6, 64)
    want = CPU.matrix_apply(ROWS, torch.from_numpy(d)).numpy()
    monkeypatch.setenv("CUBEFS_CODEC_XOR", "0")
    assert np.array_equal(bc.submit_apply("cpu", ROWS, d, engine="numpy-xor"), want)
    assert routing.last_dispatch["served"] == "numpy"
    monkeypatch.delenv("CUBEFS_CODEC_XOR")
    routing._policy = [[1 << 62, "cuda"]]
    monkeypatch.setenv("CUBEFS_CODEC_DEAD", "cuda")
    assert np.array_equal(bc.submit_apply("cpu", ROWS, d, engine="auto"), want)
    assert routing.last_dispatch == {"method": "matrix_apply", "requested": "cuda",
                                     "served": "cpp"}
    monkeypatch.delenv("CUBEFS_CODEC_DEAD")
    assert np.array_equal(bc.submit_apply("cpu", ROWS, d, engine="auto"), want)
    assert routing.last_dispatch["served"] == "cuda"


def test_host_submissions_write_their_out_rows(routing):
    """CPU tensors and numpy arrays mix in one step; each submission's
    ``out=`` rows receive its parity."""
    bc = BatchCodec(enabled=True)
    stripes = [np.zeros((1, 9, 96), np.uint8) for _ in range(2)] + [torch.zeros((2, 9, 96),
                                                                                dtype=torch.uint8)]
    for i, st in enumerate(stripes):
        st[:, :6] = torch.from_numpy(_host_stripes(20 + i, st.shape[0], 6, 96)) \
            if isinstance(st, torch.Tensor) else _host_stripes(20 + i, st.shape[0], 6, 96)
    futs = [bc.submit_encode_async("cpu", st[:, :6], 3, out=st[:, 6:], engine="cpp-xor")
            for st in stripes]
    for st, f in zip(stripes, futs):
        f.result()
        t = torch.as_tensor(st)
        assert torch.equal(t[:, 6:], CPU.encode_parity(t[:, :6], 3))
    assert bc.steps == 1


def test_host_submission_validation(routing):
    bc = BatchCodec(enabled=True)
    with pytest.raises(KeyError, match="unknown ec engine 'tpu'"):
        bc.submit_encode("cpu", np.zeros((1, 4, 32), np.uint8), 2, engine="tpu")
    with pytest.raises(ValueError, match="host-resident"):
        bc.submit_encode("cpu", torch.zeros((1, 4, 32), dtype=torch.uint8, device="meta"), 2,
                         engine="numpy")
    with pytest.raises(ValueError, match="writable"):
        bc.submit_encode("cpu", np.zeros((1, 4, 32), np.uint8), 2, engine="numpy",
                         out=np.zeros((1, 3, 32), np.uint8))
    bad = bc.submit_encode_async("cpu", np.zeros((1, 4, 32), np.int16), 2, engine="numpy")
    with pytest.raises(CodecAdmissionError, match="uint8"):
        bad.result()
    with pytest.raises(KeyError):
        admit("cpu", engine="tpu")
    assert admit(None, engine="numpy").device is None  # a host engine needs no card


def test_raising_leg_fails_the_step_and_quarantines_nothing(routing, monkeypatch):
    routing._policy = [[1 << 62, "cuda"]]
    bc = BatchCodec(enabled=True)
    real = routing.CudaEngine.encode_parity

    def lost(self, data, n_parity, out=None):
        raise RuntimeError("CUDA error: device lost")

    monkeypatch.setattr(routing.CudaEngine, "encode_parity", lost)
    futs = [bc.submit_encode_async("cpu", _host_stripes(i, 1, 4, 32), 2, engine="auto")
            for i in range(3)]
    for f in futs:
        with pytest.raises(RuntimeError, match="device lost"):
            f.result()
    monkeypatch.setattr(routing.CudaEngine, "encode_parity", real)
    d = _host_stripes(9, 1, 4, 32)
    assert np.array_equal(bc.submit_encode("cpu", d, 2, engine="auto"),
                          CPU.encode_parity(torch.from_numpy(d), 2).numpy())
    assert routing.last_dispatch["served"] == "cuda"


ENGINES = ["numpy", "cpp", "numpy-xor", "cpp-xor", "auto"]


@pytest.fixture
def ref_codec(monkeypatch):
    """The reference's encoder module (it imports jax), its routing pinned
    to a table that keeps every stripe on its host legs."""
    from cubefs_tpu.codec import encoder as ref_encoder
    from cubefs_tpu.codec import engine as ref_engine

    monkeypatch.setattr(ref_engine, "_policy", [[1 << 62, "cpp"]])
    monkeypatch.setattr(ref_engine, "_dead_engines", set())
    return ref_encoder


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "cpu_tensor"])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("mode", ["EC6P3", "EC4P4L2", "EC16P20L2", "EC6P6MSR"])
def test_host_encoder_round_trips_equal_the_reference(routing, ref_codec, mode, engine,
                                                      as_tensor):
    """``new_encoder(CodecConfig(engine=...))`` keeps stripes in host
    memory: encode, verify, reconstruct and reconstruct_data write the
    caller's rows and equal the reference's encoder of the same engine."""
    routing._policy = [[2048, "cpp-xor"], [1 << 62, "cuda"]]
    enc = new_encoder(CodecConfig(tcm.CodeMode[mode], engine=engine, device="cpu"))
    ref = ref_codec.new_encoder(ref_codec.CodecConfig(mode=tcm.CodeMode[mode].value,
                                                      engine=engine))
    payload = np.random.default_rng(len(mode)).integers(0, 256, 6 * 701 + 5, dtype=np.uint8)
    want = ref.encode(ref.split(payload.tobytes()))
    st = enc.split(payload.tobytes())
    assert isinstance(st, np.ndarray) and st.shape == want.shape
    if as_tensor:
        st = torch.from_numpy(st)
    assert enc.encode(st) is st
    assert np.array_equal(np.asarray(st), want)
    assert enc.verify(st) and ref.verify(want)
    t = enc.t
    bad = [1, t.n + 1] + ([t.n + t.m] if t.l else [])
    for fn in ("reconstruct", "reconstruct_data"):
        broken, ref_broken = st.clone() if as_tensor else st.copy(), want.copy()
        broken[bad] = 0
        ref_broken[bad] = 0
        assert getattr(enc, fn)(broken, bad) is broken
        getattr(ref, fn)(ref_broken, bad)
        assert np.array_equal(np.asarray(broken), ref_broken), fn
    assert enc.join(st, payload.size) == payload.tobytes()
    pending = enc.encode_async(st)
    assert pending.wait() is st and np.array_equal(np.asarray(st), want)


def test_host_encoder_refuses_device_tensors_and_read_only_writes(routing):
    enc = new_encoder(CodecConfig(tcm.CodeMode.EC6P3, engine="numpy"))
    assert enc.device is None and enc.host
    from cubefs_tpu_torch.codec.encoder import ECError

    with pytest.raises(ECError, match="host memory"):
        enc.encode(torch.zeros((9, 16), dtype=torch.uint8, device="meta"))
    ro = np.zeros((9, 16), np.uint8)
    ro.flags.writeable = False
    with pytest.raises(ECError, match="read-only"):
        enc.encode(ro)
    assert enc.verify(ro)
    with pytest.raises(ECError, match="uint8"):
        enc.encode(np.zeros((9, 16), np.int32))


# ---------------- on the card ----------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_coalesced_step_on_card(cuda_device, monkeypatch):
    """Eight concurrent PUT-sized encodes land as one launch of A, no
    synchronize, bit-identical to the unbatched launches."""
    syncs = []
    real_sync = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: syncs.append(a) or real_sync(*a))
    bc = BatchCodec(enabled=True)
    enc = new_encoder(CodecConfig(tcm.CodeMode.EC12P4))
    enc.engine = AdmittedEngine(bc, cuda_device)
    s = enc.shard_size(1 << 20)
    stripes = [torch.zeros((12 + 4, s), dtype=torch.uint8, device=cuda_device) for _ in range(8)]
    for i, st in enumerate(stripes):
        st[:12] = _stripes(i, 1, 12, s, cuda_device)[0]
    before = _build.LAUNCHES["gf_apply"]
    pendings = [enc.encode_async(st) for st in stripes]
    for p in pendings:
        p.wait()
    assert _build.LAUNCHES["gf_apply"] == before + 1 and bc.steps == 1
    assert not syncs
    for st in stripes:
        want = CPU.encode_parity(st[:12].cpu(), 4)
        assert torch.equal(st[12:].cpu(), want)


@pytest.mark.cuda
def test_steps_launch_on_the_callers_current_stream(cuda_device, monkeypatch):
    """An uncontended encode drains in the caller's thread: its one
    launch goes to the caller's current stream, in place, and its result
    reads correctly on that stream without a synchronize."""
    streams = []
    real_launch = _build.launch
    monkeypatch.setattr(_build, "launch", lambda name, *a: streams.append(a[-1])
                        or real_launch(name, *a))
    enc = new_encoder(CodecConfig(tcm.CodeMode.EC12P4))
    side = torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(side):
        st = torch.zeros((16, 4096 + 12), dtype=torch.uint8, device=cuda_device)
        st[:12] = _stripes(3, 1, 12, 4096 + 12, cuda_device)[0]
        ptr = st.data_ptr()
        assert enc.encode(st) is st
        ok = enc.verify(st)  # runs on `side`, after the encode
    assert streams == [side.cuda_stream, side.cuda_stream] and ok
    assert st.data_ptr() == ptr


@pytest.mark.cuda
def test_threads_share_one_batcher_on_card(cuda_device):
    bc = BatchCodec(enabled=True)
    rows = np.random.default_rng(4).integers(0, 256, (36, 36), dtype=np.uint8)
    inputs = [_stripes(i, 1, 36, 6000, cuda_device) for i in range(16)]
    outs = {}

    def work(i):
        outs[i] = bc.submit_apply(cuda_device, rows, inputs[i])

    threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    assert not any(t.is_alive() for t in threads)
    for i in range(16):
        assert torch.equal(outs[i].cpu(), CPU.matrix_apply(rows, inputs[i].cpu()))
    assert bc.submissions == 16 and bc.steps <= 16


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one", "one_with_out", "two_coalesced"])
def test_a_drainer_on_another_stream_orders_against_the_caller(cuda_device, case):
    """Submissions made on a side stream and drained by another thread on
    its own stream: the step waits for the side stream's data, the
    caller's stream waits for the step at result(), and an input the
    caller dropped before the step ran keeps its memory until the step
    has read it. Device sleeps hold up both streams (the data lands on
    `side` after about 200M cycles; the step, once it has waited for it,
    sleeps 100M more before its launch) so that a missing order shows as
    wrong parity: a step that does not wait reads the 0xAA fill, one
    whose input memory went to the caller's next tensor reads 0xFF, and
    a collector that does not wait reads the result before it is
    written."""

    class _LateStep(BatchCodec):
        def _engine_call(self, key, eng, coeff, arr, out):
            torch.cuda._sleep(100_000_000)
            return super()._engine_call(key, eng, coeff, arr, out)

    n, m, s = 12, 4, 65536 + 12
    want_in = _stripes(7, 2, n, s, cuda_device)
    want = CPU.encode_parity(want_in.cpu(), m)
    # the kernel's first use of a matrix uploads its table, a copy that
    # blocks the host until the stream gets there: do it here, so that
    # the step below blocks nothing and the streams alone order it
    CudaEngine(cuda_device).encode_parity(want_in, m)
    torch.cuda.synchronize()
    bc = _LateStep(enabled=True)
    side, drain = torch.cuda.Stream(cuda_device), torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(side):
        x = torch.full((2, n, s), 0xAA, dtype=torch.uint8, device=cuda_device)
        torch.cuda._sleep(200_000_000)
        x.copy_(want_in)
        out = (torch.zeros((2, m, s), dtype=torch.uint8, device=cuda_device)
               if case == "one_with_out" else None)
        futs = [bc.submit_encode_async(cuda_device, x, m, out=out)]
        if case == "two_coalesced":
            futs.append(bc.submit_encode_async(cuda_device, x.clone(), m))
        del x  # the futures hold it until the step is queued

    def drainer():
        with torch.cuda.stream(drain):
            futs[0].result()

    t = threading.Thread(target=drainer)
    t.start()
    t.join(timeout=60.0)
    assert not t.is_alive() and all(f.done for f in futs) and bc.steps == 1
    with torch.cuda.stream(side):
        # the same size as the dropped input: its memory, if nothing kept it
        junk = torch.full((2, n, s), 0xFF, dtype=torch.uint8, device=cuda_device)
        got = [f.result().cpu() for f in futs]
        outs = None if out is None else out.cpu()
    del junk
    assert all(torch.equal(g, want) for g in got)
    assert outs is None or torch.equal(outs, want)
