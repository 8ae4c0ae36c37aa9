"""RMSNorm in Triton for Hopper.

Replaces ``repro/kernels/rmsnorm/kernel.py::rmsnorm_pallas`` (the Pallas TPU
kernel; its body is ``_kernel`` there).

What bounds it on the H100: bytes. Each row is read once and written once,
with four operations per element, far below the ~295 operations per byte at
which the card's arithmetic would become the limit. So the design only has
to move each byte once: one program owns whole rows, ``d`` stays resident in
registers (the reduction needs all of it), the row is loaded once, reduced
and scaled in fp32, and stored once in the input dtype. The TPU kernel's
128-row VMEM blocks become ``ROWS`` rows per program; there is no tensor-core
work, so Triton's block model expresses the whole kernel.

``triton`` is imported inside :func:`rmsnorm_triton`, never at import time,
so this module imports on machines without it.
"""
from __future__ import annotations

import torch

_KERNEL = None


def _build():
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_rows(x_ptr, s_ptr, o_ptr, rows, d, eps,
                     ROWS: tl.constexpr, BLOCK_D: tl.constexpr):
        r = tl.program_id(0) * ROWS + tl.arange(0, ROWS)[:, None]
        c = tl.arange(0, BLOCK_D)[None, :]
        mask = (r < rows) & (c < d)
        x = tl.load(x_ptr + r * d + c, mask=mask, other=0.0).to(tl.float32)
        var = tl.sum(x * x, axis=1)[:, None] / d
        s = tl.load(s_ptr + c, mask=c < d, other=0.0).to(tl.float32)
        y = x * tl.math.rsqrt(var + eps) * s
        tl.store(o_ptr + r * d + c, y.to(o_ptr.dtype.element_ty), mask=mask)

    return triton, rmsnorm_rows


def rmsnorm_triton(x2: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch on a contiguous ``(rows, d)`` CUDA tensor; returns a new tensor."""
    global _KERNEL
    if _KERNEL is None:
        _KERNEL = _build()
    triton, kern = _KERNEL
    rows, d = x2.shape
    out = torch.empty_like(x2)
    block_d = triton.next_power_of_2(d)
    # keep about 8 fp32 values of the tile per thread
    num_warps = min(max(block_d // 256, 1), 16)
    rows_per = max(1, min(4, 2048 // block_d))
    grid = (triton.cdiv(rows, rows_per),)
    kern[grid](x2, scale, out, rows, d, eps,
               ROWS=rows_per, BLOCK_D=block_d, num_warps=num_warps)
    return out
