"""The benchmark of the PyTorch and CUDA port (``eav_tpu_torch``): see README.md."""
