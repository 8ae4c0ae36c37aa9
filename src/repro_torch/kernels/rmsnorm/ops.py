"""RMSNorm dispatch: the plain versions for CPU tensors, the Triton kernels
for CUDA tensors (or an error), and the kernels' launch counts.

Where autograd needs a gradient of x or of the scale, :func:`rmsnorm` goes
through a ``torch.autograd.Function`` whose backward is
:func:`rmsnorm_bwd`; otherwise it launches the forward alone."""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref


def _check(x: torch.Tensor, scale: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"{what}: scale shape {tuple(scale.shape)} != ({d},)")
    if scale.device != x.device:
        raise ValueError(f"{what}: x and scale on different devices")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: unsupported dtype {x.dtype}")
    if scale.dtype != torch.float32:
        raise TypeError(f"{what}: scale must be float32, got {scale.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"{what}: x and scale must be contiguous")


def _forward(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    _check(x, scale, "rmsnorm")
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_triton
    out = rmsnorm_triton(x.view(-1, x.shape[-1]), scale, eps)
    rmsnorm.launches += 1
    return out.view(x.shape)


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dscale) of :func:`rmsnorm` at ``x`` for the output gradient
    ``dy``: the plain gradient on the CPU, else the Triton kernel (or an
    error). dx in x's dtype, dscale fp32."""
    if x.device.type == "cpu":
        return rmsnorm_bwd_ref(x, scale, dy, eps)
    _check(x, scale, "rmsnorm_bwd")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"rmsnorm_bwd: dy {tuple(dy.shape)} {dy.dtype} does not match x")
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_bwd_triton
    d = x.shape[-1]
    dx, dscale = rmsnorm_bwd_triton(x.view(-1, d), scale, dy.contiguous().view(-1, d), eps)
    rmsnorm_bwd.launches += 1
    return dx.view(x.shape), dscale


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, dy, ctx.eps)
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim of ``x`` (any leading dims); ``scale (d,)``."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, eps)
    return _forward(x, scale, eps)


rmsnorm.launches = 0
rmsnorm_bwd.launches = 0
