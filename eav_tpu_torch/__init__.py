"""PyTorch/CUDA port of eav_tpu for NVIDIA Hopper GPUs (see README.md)."""
