"""The codec work's HBM/int8 bound over the kernels' device time, in %."""

from portbench.readers import codec_roofline as read  # noqa: F401
