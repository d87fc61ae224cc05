"""Profiling and observability helpers (``utils/profiling.py``)."""
