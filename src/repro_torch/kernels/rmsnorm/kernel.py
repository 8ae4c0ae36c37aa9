"""RMSNorm in Triton for Hopper: the forward and its backward.

The forward replaces ``repro/kernels/rmsnorm/kernel.py::rmsnorm_pallas`` (the
Pallas TPU kernel; its body is ``_kernel`` there). The backward replaces no
Pallas kernel (the TPU kernel has no VJP): it is the gradient the JAX package
takes by autodiff of ``repro/models/layers.py::rmsnorm``.

What bounds both on the H100: bytes. The forward reads each row once and
writes it once, with four operations per element; the backward reads x and
dy and writes dx, with about ten. Both are far below the ~295 operations per
byte at which the card's arithmetic would become the limit. So the design
only has to move each byte once: one program owns whole rows, ``d`` stays
resident in registers (the row reductions need all of it), the row is loaded
once, reduced and scaled in fp32, and stored once in the input dtype. The TPU
kernel's 128-row VMEM blocks become ``ROWS`` rows per program; there is no
tensor-core work, so Triton's block model expresses the whole kernel: one
row reduction (forward and dx), one column reduction (dscale).

The backward (``rmsnorm_bwd_rows``): r = rsqrt(mean(x**2) + eps) and x_hat =
x r per row, recomputed from x (the forward keeps nothing), dx = r (dy s -
x_hat mean(dy s x_hat)). dscale = sum over rows of dy x_hat is a two-stage
reduction in a fixed order, so the result is the same bits from call to
call: each program walks a fixed set of row blocks and writes its partial
sum to its own row of a (programs, d) fp32 scratch; ``col_sum`` then sums
that scratch down its columns. No atomics.

``triton`` is imported inside the launchers, never at import time, so this
module imports on machines without it.
"""
from __future__ import annotations

import torch

_KERNELS = None
_SMS: dict = {}


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

    @triton.jit
    def rmsnorm_bwd_rows(x_ptr, s_ptr, dy_ptr, dx_ptr, part_ptr, rows, d, eps,
                         ROWS: tl.constexpr, BLOCK_D: tl.constexpr):
        pid = tl.program_id(0)
        progs = tl.num_programs(0)
        cols = tl.arange(0, BLOCK_D)
        c = cols[None, :]
        s = tl.load(s_ptr + c, mask=c < d, other=0.0).to(tl.float32)
        part = tl.zeros((ROWS, BLOCK_D), dtype=tl.float32)
        for blk in range(pid, tl.cdiv(rows, ROWS), progs):
            r = blk * ROWS + tl.arange(0, ROWS)[:, None]
            mask = (r < rows) & (c < d)
            x = tl.load(x_ptr + r * d + c, mask=mask, other=0.0).to(tl.float32)
            dy = tl.load(dy_ptr + r * d + c, mask=mask, other=0.0).to(tl.float32)
            rstd = tl.math.rsqrt(tl.sum(x * x, axis=1)[:, None] / d + eps)
            xhat = x * rstd
            g = dy * s
            dx = rstd * (g - xhat * (tl.sum(g * xhat, axis=1)[:, None] / d))
            tl.store(dx_ptr + r * d + c, dx.to(dx_ptr.dtype.element_ty), mask=mask)
            part += dy * xhat
        tl.store(part_ptr + pid * d + cols, tl.sum(part, axis=0), mask=cols < d)

    @triton.jit
    def col_sum(part_ptr, out_ptr, n, d, BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        acc = tl.zeros((BLOCK_C,), dtype=tl.float32)
        for p0 in range(0, n, BLOCK_P):
            p = p0 + tl.arange(0, BLOCK_P)[:, None]
            m = (p < n) & (cols[None, :] < d)
            acc += tl.sum(tl.load(part_ptr + p * d + cols[None, :], mask=m, other=0.0),
                          axis=0)
        tl.store(out_ptr + cols, acc, mask=cols < d)

    return triton, rmsnorm_rows, rmsnorm_bwd_rows, col_sum


def _kernels():
    global _KERNELS
    if _KERNELS is None:
        _KERNELS = _build()
    return _KERNELS


def _shape(d: int, triton):
    block_d = triton.next_power_of_2(d)
    # keep about 8 fp32 values of the tile per thread
    num_warps = min(max(block_d // 256, 1), 16)
    rows_per = max(1, min(4, 2048 // block_d))
    return block_d, num_warps, rows_per


def rmsnorm_triton(x2: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch on a contiguous ``(rows, d)`` CUDA tensor; returns a new tensor."""
    triton, kern, _, _ = _kernels()
    rows, d = x2.shape
    out = torch.empty_like(x2)
    block_d, num_warps, rows_per = _shape(d, triton)
    grid = (triton.cdiv(rows, rows_per),)
    kern[grid](x2, scale, out, rows, d, eps,
               ROWS=rows_per, BLOCK_D=block_d, num_warps=num_warps)
    return out


def rmsnorm_bwd_triton(x2: torch.Tensor, scale: torch.Tensor, dy2: torch.Tensor,
                       eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward on contiguous ``(rows, d)`` CUDA tensors x and dy
    and the fp32 scale; returns new (dx, dscale). Four programs per SM at
    most, each over every ``programs``-th block of rows."""
    triton, _, bwd, col_sum = _kernels()
    rows, d = x2.shape
    dev = x2.device.index if x2.device.index is not None else torch.cuda.current_device()
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    block_d, num_warps, rows_per = _shape(d, triton)
    progs = max(1, min(4 * _SMS[dev], triton.cdiv(rows, rows_per)))
    dx = torch.empty_like(x2)
    part = torch.empty((progs, d), dtype=torch.float32, device=x2.device)
    dscale = torch.empty((d,), dtype=torch.float32, device=x2.device)
    bwd[(progs,)](x2, scale, dy2, dx, part, rows, d, eps,
                  ROWS=rows_per, BLOCK_D=block_d, num_warps=num_warps)
    block_c = 128
    col_sum[(triton.cdiv(d, block_c),)](part, dscale, progs, d,
                                        BLOCK_P=32, BLOCK_C=block_c, num_warps=4)
    return dx, dscale
