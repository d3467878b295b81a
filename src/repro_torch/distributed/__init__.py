"""Fault tolerance of the training loop (mirrors ``src/repro/distributed/``;
mesh sharding waits for ROADMAP A10)."""
