"""Plain PyTorch RMSNorm: the CPU path and the kernel's yardstick on the card."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per row of the last dim: ``x * rsqrt(mean(x**2) + eps) * scale`` in
    fp32, cast back to ``x.dtype``."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradient of :func:`rmsnorm_ref`, in fp32: with r = rsqrt(mean(x**2)
    + eps) and x_hat = x r per row, dx = r (dy s - x_hat mean(dy s x_hat))
    (cast to x's dtype) and dscale = the sum over rows of dy x_hat (fp32)."""
    d = x.shape[-1]
    x32, dy32 = x.float().reshape(-1, d), dy.float().reshape(-1, d)
    r = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    xhat = x32 * r
    g = dy32 * scale.float()
    dx = r * (g - xhat * torch.mean(g * xhat, dim=-1, keepdim=True))
    return dx.reshape(x.shape).to(x.dtype), (dy32 * xhat).sum(0)
