"""RMSNorm dispatch: the plain version for CPU tensors, the Triton kernel for
CUDA tensors (or an error), and the kernel's launch count."""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim of ``x`` (any leading dims); ``scale (d,)``."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"rmsnorm: scale shape {tuple(scale.shape)} != ({d},)")
    if scale.device != x.device:
        raise ValueError("rmsnorm: x and scale on different devices")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rmsnorm: unsupported dtype {x.dtype}")
    if scale.dtype != torch.float32:
        raise TypeError(f"rmsnorm: scale must be float32, got {scale.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: x and scale must be contiguous")
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_triton
    out = rmsnorm_triton(x.view(-1, d), scale, eps)
    rmsnorm.launches += 1
    return out.view(x.shape)


rmsnorm.launches = 0
