"""cubefs_tpu_torch: the erasure-coding and CRC device plane on PyTorch + CUDA.

The port of the JAX package ``cubefs_tpu`` to an NVIDIA H100. Its
layout mirrors the JAX package (``ops/rs_kernel.py`` here is the
counterpart of ``cubefs_tpu/ops/rs_kernel.py``). It imports torch and
numpy only, never jax and nothing of ``cubefs_tpu``.

The two Pallas kernels of the JAX package are hand-written CUDA here
(``csrc/gf_apply.cu``, ``csrc/crc32_blocks.cu``), built with nvcc for
sm_90a at first use (``ops/_build.py``). A CUDA tensor goes to a kernel;
a CPU tensor to the kernel's plain PyTorch version. Entry points run on
the CUDA device unless the caller passes ``device="cpu"``.
"""
