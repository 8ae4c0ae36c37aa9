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
