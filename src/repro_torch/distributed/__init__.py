"""Multi-device runtime of the port (mirrors ``src/repro/distributed/``):
the sharding spec functions and a training step's layout (``sharding``:
``constrain``, ``weight_use``, ``TrainShard``), tensor-parallel weights
for serving and their differentiable use in training (``param_sharding``),
the differentiable collectives of a training mesh (``collectives``) and
the training loop's fault tolerance with ``elastic_remesh``
(``fault_tolerance``)."""
