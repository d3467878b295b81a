"""The port's kernels, all CUDA C++: paged attention, rmsnorm (forward and
backward), flash attention (forward and backward), matrix product,
segmented LoRA shrink/expand and selective scan, each beside its plain
PyTorch version (``ref``).

A wrapper takes the branch its tensors' device names
(``device_branch``): the kernel for CUDA tensors, the plain version for
CPU ones, and for ``meta`` tensors (the dry run's) empty outputs of the
right shapes and dtypes.  The training path's wrappers (K2, K3, K7) report
each call to the dry run's cost analyzer through ``costed``."""
import threading

import torch

# Each wrapper counts its launches in a module global.  Two engines in one
# process (a gateway routing two models) launch from two stepper threads,
# so every increment holds this lock: a lost count would fail the launch
# checks of ``chip_smoke.py``.
_count_lock = threading.Lock()


def count(counters: dict, name: str) -> None:
    """Add one to the launch counter ``counters[name]`` (a wrapper module's
    ``globals()``), atomically across threads."""
    with _count_lock:
        counters[name] += 1


# the cost analyzer of ``launch.hlo_analysis.analyze_step`` while one
# runs, else None (a module global: the backward runs on autograd's own
# thread)
analyzer = None


def costed(name: str, flops: int, fn, *args):
    """``fn(*args)``: one call of a kernel wrapper on whichever branch its
    tensors take, reported to the active analyzer as one launch of
    ``name`` with ``flops`` and its outputs' bytes, the torch ops inside
    uncounted.  A call then counts the same whatever implements it (the
    CUDA kernel, the CPU plain version or meta)."""
    a = analyzer
    if a is None:
        return fn(*args)
    return a.kernel(name, flops, fn, *args)


def device_branch(name: str, x) -> str:
    """"cuda", "cpu" or "meta": the branch a wrapper takes for ``x``'s
    device; raise on any other."""
    kind = x.device.type
    if kind not in ("cuda", "cpu", "meta"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return kind


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


def launch(what: str, dev, fn, *args) -> None:
    """Call the C entry ``fn(*args, stream)`` on the current stream of the
    CUDA device ``dev`` and raise if it returns a CUDA error, entering the
    device's context only when it is not the current device.  The raw
    stream handle is read as PyTorch's own kernel launchers read it (no
    Stream object is built on this per-call path)."""
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return launch(what, dev, fn, *args)
    err = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")
