"""The port's kernels: CUDA C++ paged attention and Triton rmsnorm, each
beside its plain PyTorch version (``ref``)."""
