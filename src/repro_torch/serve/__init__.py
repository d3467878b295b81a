"""Paged serving stack of the port: block pool, tiered KV store, multi-LoRA
adapter store, faults and the continuous-batching engine."""
