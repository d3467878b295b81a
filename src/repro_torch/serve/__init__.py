"""Paged serving stack of the port: block pool, tiered KV store, faults and
the continuous-batching engine."""
