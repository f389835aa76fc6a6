"""The batcher's dp split (``cubefs_tpu_torch/codec/batcher.py``) against
the reference's (``cubefs_tpu/codec/batcher.py`` ``_maybe_dp``).

The reference shards a drained step dp-wise over a mesh of
``jax.devices()`` (here testenv's 8 virtual CPU devices); the port cuts
it into blocks over the devices its ``BatchCodec`` lists, one after
another on ``device="cpu"`` with the plain version. Both legs of the
port are held: device tensors of the ``cuda`` engine, and host stripes
that ``auto`` routes to the ``cuda`` leg (``hostio.staged`` per block).
Then the cases where the split does not engage, in both packages, and
the one where they part: an engaged split that fails raises to the
step's futures in the port, where the reference returns to the unsplit
engine.

The reference is imported in fixtures: the ``cuda`` test at the end runs
on a machine with only the port's dependencies:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_batcher_dp.py

Numpy-seeded inputs; tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

from cubefs_tpu_torch.codec.batcher import BatchCodec
from cubefs_tpu_torch.codec.engine import CudaEngine
from cubefs_tpu_torch.utils import metrics

CPU = CudaEngine("cpu")  # the unsplit step every result is held against
ROWS = np.ascontiguousarray(np.arange(1, 19, dtype=np.uint8).reshape(3, 6))
LEGS = ("cuda", "auto")  # device tensors; host stripes on auto's cuda leg


@pytest.fixture
def ref():
    """The reference's batcher, metrics and engines on the 8-device mesh."""
    import jax

    from cubefs_tpu.codec import batcher as ref_batcher
    from cubefs_tpu.codec.engine import get_engine
    from cubefs_tpu.utils import metrics as ref_metrics

    assert len(jax.devices()) == 8
    return ref_batcher, ref_metrics, get_engine


@pytest.fixture
def routing(monkeypatch, tmp_path):
    """``auto`` routes every step to the ``cuda`` leg; no drill, the XOR
    door open."""
    from cubefs_tpu_torch.codec import engine as E

    monkeypatch.setattr(E, "_policy_path", lambda: str(tmp_path / "CROSSOVER.json"))
    monkeypatch.setattr(E, "_policy", [[1 << 62, "cuda"]])
    for var in ("CUBEFS_CODEC_DEAD", "CUBEFS_CODEC_XOR", "CUBEFS_TPU_EC_ENGINE",
                "CUBEFS_CODEC_DP", "CUBEFS_CODEC_DP_MIN_BYTES"):
        monkeypatch.delenv(var, raising=False)
    return E


def _stripes(seed, b, n, s):
    return np.random.default_rng(seed).integers(0, 256, (b, n, s), dtype=np.uint8)


def _dp_steps(mod, dp: int) -> float:
    return mod.codec_batch_dp_steps.value(dp=dp)


def _all_dp_steps(mod) -> float:
    return sum(v for _, v in mod.codec_batch_dp_steps.samples())


def port_step(bc: BatchCodec, leg: str, op: str, x: np.ndarray) -> np.ndarray:
    """One step of ``x`` through the port's leg, as numpy."""
    data = torch.from_numpy(x) if leg == "cuda" else x
    if op == "encode":
        y = bc.submit_encode("cpu", data, 3, engine=leg)
    else:
        y = bc.submit_apply("cpu", ROWS, data, engine=leg)
    return y.numpy() if isinstance(y, torch.Tensor) else y


def unsplit(op: str, x: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(x)
    return (CPU.encode_parity(t, 3) if op == "encode" else CPU.matrix_apply(ROWS, t)).numpy()


@pytest.mark.parametrize("leg", LEGS)
def test_split_equals_the_reference_on_the_8_device_mesh(ref, routing, leg):
    """The recipe of ``test_codec_batch.test_dp_sharded_step_bit_identical``:
    B = 8 stripes of 6 x 256, every step split; encode and apply give
    the reference's bytes, and each package counts two steps at dp 8."""
    ref_batcher, ref_metrics, get_engine = ref
    d = _stripes(8, 8, 6, 256)
    rb = ref_batcher.BatchCodec(enabled=True)
    rb.dp_min_bytes = 0
    bc = BatchCodec(enabled=True, devices=["cpu"] * 8)
    bc.dp_min_bytes = 0
    ref0, port0 = _dp_steps(ref_metrics, 8), _dp_steps(metrics, 8)
    want_enc = rb.submit_encode("tpu", d, 3)
    want_app = rb.submit_apply("tpu", ROWS, d)
    assert _dp_steps(ref_metrics, 8) == ref0 + 2
    assert np.array_equal(want_enc, get_engine("numpy").encode_parity(d, 3))
    assert np.array_equal(want_app, get_engine("numpy").matrix_apply(ROWS, d))
    assert np.array_equal(port_step(bc, leg, "encode", d), want_enc)
    assert np.array_equal(port_step(bc, leg, "apply", d), want_app)
    assert _dp_steps(metrics, 8) == port0 + 2
    assert bc.steps == 2
    if leg == "auto":
        assert routing.last_dispatch["served"] == "cuda"


@pytest.mark.parametrize("leg", LEGS)
@pytest.mark.parametrize("op", ["encode", "apply"])
def test_uneven_batch_splits_to_the_same_bytes(ref, routing, leg, op):
    """B = 5 over 2 devices: blocks of 3 and 2 stripes, no padding; the
    bytes of the reference's step of the same stripes (dp 5 on its mesh)
    and of the unsplit step."""
    ref_batcher, _, _ = ref
    d = _stripes(5, 5, 6, 200)
    rb = ref_batcher.BatchCodec(enabled=True)
    rb.dp_min_bytes = 0
    want = (rb.submit_encode("tpu", d, 3) if op == "encode"
            else rb.submit_apply("tpu", ROWS, d))
    bc = BatchCodec(enabled=True, devices=["cpu", "cpu"])
    bc.dp_min_bytes = 0
    before = _dp_steps(metrics, 2)
    got = port_step(bc, leg, op, d)
    assert _dp_steps(metrics, 2) == before + 1
    assert np.array_equal(got, want)
    assert np.array_equal(got, unsplit(op, d))


@pytest.mark.parametrize("leg", LEGS)
def test_split_writes_the_callers_out_rows(routing, leg):
    """A one-submission step hands its ``out=`` rows (here the parity rows
    of the caller's stripes) to the split, which writes each block's
    parity there."""
    st = _stripes(11, 4, 9, 300)
    want = unsplit("encode", np.ascontiguousarray(st[:, :6]))
    bc = BatchCodec(enabled=True, devices=["cpu"] * 3)
    bc.dp_min_bytes = 0
    before = _dp_steps(metrics, 3)
    host = st if leg == "auto" else torch.from_numpy(st)
    got = bc.submit_encode("cpu", host[:, :6], 3, out=host[:, 6:], engine=leg)
    assert _dp_steps(metrics, 3) == before + 1
    assert np.array_equal(st[:, 6:], want)
    ptr = got.__array_interface__["data"][0] if leg == "auto" else got.data_ptr()
    assert ptr == st[:, 6:].__array_interface__["data"][0]  # the caller's rows, returned


@pytest.mark.parametrize("case", ["switch_off", "below_min_bytes", "one_stripe", "one_device",
                                  "no_card_visible"])
@pytest.mark.parametrize("leg", LEGS)
def test_no_split(ref, routing, monkeypatch, leg, case):
    """The split does not engage, in either package, with the switch off,
    below ``dp_min_bytes``, for B = 1, or over fewer than two devices
    (``devices=None`` on this CPU host lists no card): the step runs
    unsplit, and no dp step is counted."""
    ref_batcher, ref_metrics, _ = ref
    b = 1 if case == "one_stripe" else 8
    d = _stripes(3, b, 6, 256)
    if case == "switch_off":
        monkeypatch.setenv("CUBEFS_CODEC_DP", "0")
    devices = {"one_device": ["cpu"], "no_card_visible": None}.get(case, ["cpu"] * 8)
    bc = BatchCodec(enabled=True, devices=devices)
    rb = ref_batcher.BatchCodec(enabled=True)
    assert bc.dp_enabled is rb.dp_enabled is (case != "switch_off")
    assert bc.dp_min_bytes == rb.dp_min_bytes == 1 << 20
    if case != "below_min_bytes":
        bc.dp_min_bytes = rb.dp_min_bytes = 0
    if case != "one_device" and case != "no_card_visible":  # the mesh has 8
        assert rb._maybe_dp("tpu", None, d, 3) is None
    port0, ref0 = _all_dp_steps(metrics), _all_dp_steps(ref_metrics)
    assert np.array_equal(port_step(bc, leg, "encode", d), unsplit("encode", d))
    assert _all_dp_steps(metrics) == port0
    assert _all_dp_steps(ref_metrics) == ref0


@pytest.mark.parametrize("leg", LEGS)
def test_an_engaged_split_that_fails_raises_to_its_futures(ref, routing, leg):
    """Devices that name ``cuda:0`` on this CPU host: the step's every
    future raises, no step or dp step is counted, and the queue serves
    the next step. The reference, whose mesh fails alike, returns to the
    unsplit engine instead (its ``_maybe_dp`` gives None)."""
    ref_batcher, _, get_engine = ref
    d = _stripes(4, 4, 6, 128)
    bc = BatchCodec(enabled=True, devices=["cuda:0", "cuda:0"])
    bc.dp_min_bytes = 0
    data = torch.from_numpy(d) if leg == "cuda" else d
    port0, steps0 = _all_dp_steps(metrics), metrics.codec_batch_steps.value(
        op="encode", engine="cuda")
    futs = [bc.submit_encode_async("cpu", data[i:i + 2], 3, engine=leg) for i in (0, 2)]
    for f in futs:
        with pytest.raises(RuntimeError, match="CUDA"):
            f.result()
    assert _all_dp_steps(metrics) == port0
    assert metrics.codec_batch_steps.value(op="encode", engine="cuda") == steps0
    assert bc._queues == {} and bc._pending == 0
    bc.dp_enabled = False  # the same queue, unsplit
    assert np.array_equal(port_step(bc, leg, "encode", d), unsplit("encode", d))

    rb = ref_batcher.BatchCodec(enabled=True)
    rb.dp_min_bytes = 0

    def lost(*args):
        raise RuntimeError("mesh lost")

    rb._dp_fn = lost
    assert rb._maybe_dp("tpu", None, d, 3) is None
    assert np.array_equal(rb.submit_encode("tpu", d, 3), get_engine("numpy").encode_parity(d, 3))


# ---------------- on the card ----------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_split_on_the_card_named_twice(cuda_device, monkeypatch):
    """One card named twice: an EC12P4 step of 8 stripes runs as two
    launches of A, one a block, into the step's rows, equal to the
    unsplit launch; a list naming a card that is not there fails the
    step's future. With ``devices=None`` and one card nothing splits."""
    from cubefs_tpu_torch.ops import _build

    monkeypatch.delenv("CUBEFS_CODEC_DP", raising=False)
    x = torch.randint(0, 256, (8, 12, 1 << 16), dtype=torch.uint8, device=cuda_device)
    want = CudaEngine(cuda_device).encode_parity(x, 4)
    bc = BatchCodec(enabled=True, devices=[cuda_device, cuda_device])
    bc.dp_min_bytes = 0
    before, dp0 = _build.LAUNCHES["gf_apply"], _dp_steps(metrics, 2)
    got = bc.submit_encode(cuda_device, x, 4)
    assert torch.equal(got, want)
    assert _build.LAUNCHES["gf_apply"] - before == 2
    assert _dp_steps(metrics, 2) == dp0 + 1
    missing = torch.device("cuda", torch.cuda.device_count())
    bad = BatchCodec(enabled=True, devices=[cuda_device, missing])
    bad.dp_min_bytes = 0
    with pytest.raises(RuntimeError, match="not there"):
        bad.submit_encode(cuda_device, x, 4)
    if torch.cuda.device_count() == 1:
        one = BatchCodec(enabled=True)
        one.dp_min_bytes = 0
        dp_all = _all_dp_steps(metrics)
        assert torch.equal(one.submit_encode(cuda_device, x, 4), want)
        assert _all_dp_steps(metrics) == dp_all
