"""PyTorch/CUDA port of the ``repro`` compiler and serving stack.

Mirrors the module layout of ``src/repro`` (core, pipeline, configs,
kernels, models, serve, launch) so each module has an obvious counterpart,
but imports nothing of the JAX package: framework-free modules are kept as
copies here.  Device numbers live in one hardware record
(``core/hardware.py``, the H100 SXM).  Paged attention, rmsnorm, flash
attention, the matrix product, the segmented LoRA shrink/expand and the
selective scan run hand-written CUDA C++ kernels when the tensors live on a
CUDA device; CPU tensors take the plain PyTorch versions.
"""
