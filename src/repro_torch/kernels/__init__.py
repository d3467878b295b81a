"""The port's kernels: CUDA C++ paged attention, matrix product and
segmented LoRA shrink/expand, and Triton rmsnorm, each beside its plain
PyTorch version (``ref``)."""
