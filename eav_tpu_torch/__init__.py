"""PyTorch/CUDA port of eav_tpu for NVIDIA Hopper GPUs (see README.md).

Layout, as the JAX package's: ``core`` (configs, optimizer semantics,
metrics, checkpoints, the sweep), ``ingest`` (host decode, the native
library, on-device preprocessing), ``ops`` (signal DSP and the CUDA
kernels), ``models``, ``parallel`` (the mesh, data and tensor parallelism,
subject stacking, the task farm, the multi-process seam) and ``train``.
"""

from eav_tpu_torch.core.config import (  # noqa: F401
    PRESETS,
    AudioPreprocConfig,
    EEGPreprocConfig,
    FinetuneConfig,
    PhaseConfig,
    SplitConfig,
    SweepConfig,
    VisionPreprocConfig,
    get_preset,
)
