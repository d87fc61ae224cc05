"""The plain PyTorch LFM2-MoE reference the port's tests hold it against.

One set of equations serves the tests and the benchmark: they are written
once, in ``benchmark/reference/lfm2_moe.py`` (plain ``torch``, float32 with
TF32 off; no JAX, no ``eav_tpu``, nothing of the port), which the benchmark
keeps among its own files; this module names it."""

from benchmark.reference.lfm2_moe import *  # noqa: F401,F403 (the module's names)
