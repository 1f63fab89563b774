"""The ``(data, model)`` mesh of the port over ``torch.distributed``: the
process group (``distributed.py``), the mesh and its collectives
(``mesh.py``) and the predictors' tensor parallelism (``partitioning.py``)."""
