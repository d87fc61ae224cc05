"""Subject-parallel training (``parallel/subject.py``)."""
