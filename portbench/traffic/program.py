"""The benchmark's handles on the program under test: its codec entry for
host stripes and the counters the per-layer metrics read. The drivers
reach ``cubefs_tpu_torch`` through here and their own imports alone."""

from __future__ import annotations

from cubefs_tpu_torch.blob import codecio
from cubefs_tpu_torch.codec import codemode as cm
from cubefs_tpu_torch.utils import metrics

# the program's counters that per-layer metrics read
COUNTERS = (metrics.codec_batch_submissions, metrics.codec_batch_steps)


def encoder(cfg: dict, device):
    """The codemode's encoder over host stripes, as the access builds it
    (``codecio.encoder``) under the configuration's engine."""
    return codecio.encoder(cm.CodeMode[cfg["codemode"]], device, cfg["engine"])


def counters() -> list[tuple[str, dict, float]]:
    """Every series of ``COUNTERS``: (name, labels, value)."""
    return [(m.name, dict(zip(m.label_names, key)), float(v))
            for m in COUNTERS for key, v in m.samples()]
