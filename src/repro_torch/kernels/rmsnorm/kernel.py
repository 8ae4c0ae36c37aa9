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

The backward (``rmsnorm_bwd``), one launch: r = rsqrt(mean(x**2) + eps) and
x_hat = x r per row, recomputed from x (the forward keeps nothing), dx = r
(dy s - x_hat mean(dy s x_hat)). Each program walks a fixed set of row
blocks (every ``programs``-th block of ``ROWS`` rows) in a loop that Triton
pipelines (``tl.range(..., num_stages=STAGES)``: the next blocks' loads are
in flight while one is computed), and writes its part of dscale = the sum
over rows of dy x_hat to its own row of a fp32 scratch. Then it takes a
ticket from its group's counter (one atomic add, acquire-release, after a
barrier of the program's threads; a group is ``_GROUP`` programs in program
order): the program that draws the group's last ticket knows the group's
partials are written, sums them in program order into the group's row of
the scratch, resets the counter to 0 for the next call, and takes a ticket
from one more counter in the same way; the group that draws its last ticket
sums the groups' rows in group order into dscale, so that no program reads
more than a few tiles of partials in its serial loop. The order of every
sum is fixed, so the result is the same bits from call to call. The counters
are int32 per device: calls on one stream (the port's) never overlap.

``triton`` is imported inside the launchers, never at import time, so this
module imports on machines without it.
"""
from __future__ import annotations

import torch

_KERNELS = None
_SMS: dict = {}
_TICKETS: dict = {}      # per device: the ticket counters, 0 between calls
_GROUP = 16              # programs whose partials one of them sums
# The backward's row blocks in flight per program and programs per SM
BWD_STAGES, BWD_PER_SM = 3, 2


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
    def rmsnorm_bwd(x_ptr, s_ptr, dy_ptr, dx_ptr, part_ptr, ds_ptr, ticket_ptr, rows, d,
                    eps, ROWS: tl.constexpr, BLOCK_D: tl.constexpr, STAGES: tl.constexpr,
                    GROUP: tl.constexpr, BLOCK_P: tl.constexpr):
        pid = tl.program_id(0)
        progs = tl.num_programs(0)
        cols = tl.arange(0, BLOCK_D)
        c = cols[None, :]
        s = tl.load(s_ptr + c, mask=c < d, other=0.0).to(tl.float32)
        part = tl.zeros((ROWS, BLOCK_D), dtype=tl.float32)
        for blk in tl.range(pid, tl.cdiv(rows, ROWS), progs, num_stages=STAGES):
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
        # the last of a group of GROUP programs to finish sums the group's
        # partials; the last group to finish sums the groups' sums
        grp = pid // GROUP
        first = grp * GROUP
        size = tl.minimum(GROUP, progs - first)
        tl.debug_barrier()          # every thread's part stored before the ticket
        if tl.atomic_add(ticket_ptr + 1 + grp, 1, sem="acq_rel") == size - 1:
            acc = tl.zeros((BLOCK_D,), dtype=tl.float32)
            for p0 in range(0, size, BLOCK_P):
                p = first + p0 + tl.arange(0, BLOCK_P)[:, None]
                acc += tl.sum(tl.load(part_ptr + p * d + c, mask=(p < first + size) & (c < d),
                                      other=0.0, cache_modifier=".cg"), axis=0)
            groups = tl.cdiv(progs, GROUP)
            tl.store(part_ptr + (progs + grp) * d + cols, acc, mask=cols < d)
            tl.atomic_xchg(ticket_ptr + 1 + grp, 0)
            tl.debug_barrier()
            if tl.atomic_add(ticket_ptr, 1, sem="acq_rel") == groups - 1:
                acc = tl.zeros((BLOCK_D,), dtype=tl.float32)
                for p0 in range(0, groups, BLOCK_P):
                    p = progs + p0 + tl.arange(0, BLOCK_P)[:, None]
                    acc += tl.sum(tl.load(part_ptr + p * d + c,
                                          mask=(p < progs + groups) & (c < d), other=0.0,
                                          cache_modifier=".cg"), axis=0)
                tl.store(ds_ptr + cols, acc, mask=cols < d)
                tl.atomic_xchg(ticket_ptr, 0)

    return triton, rmsnorm_rows, rmsnorm_bwd


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


def _bwd_shape(d: int, triton):
    """(BLOCK_D, warps, rows per block) of the backward: 32 fp32 values of a
    block per thread, at most 4 rows. At d = 960 that is 4 rows over 4 warps,
    with BWD_STAGES and BWD_PER_SM the fastest of the shapes that
    ``scripts/compare_kernels.py --sweep`` timed on an H100 (PERF.md)."""
    block_d, num_warps, _ = _shape(d, triton)
    return block_d, num_warps, max(1, min(4, 32 * 32 * num_warps // block_d))


def rmsnorm_triton(x2: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch on a contiguous ``(rows, d)`` CUDA tensor; returns a new tensor."""
    triton, kern, _ = _kernels()
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
    and the fp32 scale; returns new (dx, dscale). ``BWD_PER_SM`` programs
    per SM, each over every ``programs``-th block of rows (``_bwd_shape``),
    ``BWD_STAGES`` blocks in flight."""
    triton, _, bwd = _kernels()
    rows, d = x2.shape
    dev = x2.device.index if x2.device.index is not None else torch.cuda.current_device()
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
        _TICKETS[dev] = torch.zeros((1 + 1024,), dtype=torch.int32, device=x2.device)
    block_d, num_warps, rows_per = _bwd_shape(d, triton)
    progs = max(1, min(BWD_PER_SM * _SMS[dev], triton.cdiv(rows, rows_per)))
    groups = triton.cdiv(progs, _GROUP)
    if groups >= _TICKETS[dev].numel():
        raise ValueError(f"rmsnorm_bwd: {progs} programs need more than "
                         f"{_TICKETS[dev].numel() - 1} group tickets")
    dx = torch.empty_like(x2)
    part = torch.empty((progs + groups, d), dtype=torch.float32, device=x2.device)
    dscale = torch.empty((d,), dtype=torch.float32, device=x2.device)
    # a tile of BLOCK_P partials is about 64 fp32 values per thread
    block_p = max(1, min(_GROUP, 64 * 32 * num_warps // block_d))
    bwd[(progs,)](x2, scale, dy2, dx, part, dscale, _TICKETS[dev], rows, d, eps,
                  ROWS=rows_per, BLOCK_D=block_d, STAGES=BWD_STAGES, GROUP=_GROUP,
                  BLOCK_P=block_p, num_warps=num_warps)
    return dx, dscale
