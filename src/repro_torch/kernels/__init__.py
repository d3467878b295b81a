"""The port's kernels: CUDA C++ paged attention and matrix product, and
Triton rmsnorm, each beside its plain PyTorch version (``ref``)."""
