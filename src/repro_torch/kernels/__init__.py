"""The port's kernels: CUDA C++ paged attention, flash attention (forward and
backward), matrix product, segmented LoRA shrink/expand and selective scan,
and Triton rmsnorm, each beside its plain PyTorch version (``ref``)."""
import torch


def refuse_grad(name: str, *tensors) -> None:
    """Raise if autograd would record through a kernel wrapper.

    A kernel writes into a ``torch.empty`` output that has no ``grad_fn``,
    so a loss computed through a wrapper would silently drop the gradient of
    every input.  Differentiable paths call the wrappers inside a
    ``torch.autograd.Function`` (whose forward runs with grad mode off);
    serving runs under ``no_grad`` or on tensors that need no gradient.
    Every wrapper calls this before it looks at the device, so the CPU shows
    the same refusal as the card."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and the kernel's output would "
            "carry no gradient; call it through its autograd.Function "
            "(ops.flash_attention, ops.rmsnorm) or under torch.no_grad()")
