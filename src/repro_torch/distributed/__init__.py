"""Multi-device runtime of the port (mirrors ``src/repro/distributed/``):
the sharding spec functions (``sharding``), tensor-parallel weights for
serving (``param_sharding``) and the training loop's fault tolerance
(``fault_tolerance``).  Training on a mesh waits for ROADMAP A10b."""
