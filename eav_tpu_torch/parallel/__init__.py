"""The multi-card layer: the mesh (``mesh.py``), data parallelism (in
``train/loop.py``'s ``Trainer.fit(mesh=)``), tensor parallelism (``tp.py``),
subject-parallel training (``subject.py``), the task farm over devices
(``farm.py``), the multi-process seam (``distributed.py``) and its dry run
(``dryrun.py``)."""
