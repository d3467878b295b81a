"""PyTorch/CUDA port of the ``repro`` serving stack.

Mirrors the module layout of ``src/repro`` (configs, kernels, models, serve,
launch) so each module has an obvious counterpart, but imports nothing of the
JAX package: framework-free modules are kept as copies here.  Paged attention
runs a hand-written CUDA C++ kernel and rmsnorm a Triton kernel when the
tensors live on a CUDA device; CPU tensors take the plain PyTorch versions.
"""
