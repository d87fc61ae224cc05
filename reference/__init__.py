"""Plain PyTorch references the port is held against in its tests."""
