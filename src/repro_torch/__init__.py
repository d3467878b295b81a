"""PyTorch/CUDA port of the ``repro`` compiler and serving stack.

Mirrors the module layout of ``src/repro`` (core, pipeline, configs,
kernels, models, serve, launch) so each module has an obvious counterpart,
but imports nothing of the JAX package: framework-free modules are kept as
copies here.  Device numbers live in one hardware record
(``core/hardware.py``, the H100 SXM).  Paged attention and the matrix
product run hand-written CUDA C++ kernels and rmsnorm a Triton kernel when
the tensors live on a CUDA device; CPU tensors take the plain PyTorch
versions.
"""
