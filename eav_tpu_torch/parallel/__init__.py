"""Subject-parallel training (``parallel/subject.py``) and the task farm
over devices (``parallel/farm.py``)."""
