"""The Triton body of the rmsnorm kernel.

It imports ``triton`` at the top, so only ``rmsnorm.rmsnorm_kernel`` imports
it, at its first launch on a CUDA tensor; the rest of the package imports on
hosts without Triton.
"""
import triton
import triton.language as tl


@triton.jit
def rmsnorm_rows(x_ptr, w_ptr, o_ptr, n_rows, d, eps,
                 BLOCK_D: tl.constexpr, ROWS: tl.constexpr):
    pid = tl.program_id(0)
    rows = pid * ROWS + tl.arange(0, ROWS)
    cols = tl.arange(0, BLOCK_D)
    mask = (rows[:, None] < n_rows) & (cols[None, :] < d)
    offs = rows[:, None].to(tl.int64) * d + cols[None, :]
    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    w = tl.load(w_ptr + cols, mask=cols < d, other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=1) / d
    y = x * (1.0 / tl.sqrt(var + eps))[:, None] * w[None, :]
    tl.store(o_ptr + offs, y.to(o_ptr.dtype.element_ty), mask=mask)
