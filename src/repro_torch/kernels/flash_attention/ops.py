"""Flash-attention dispatch: the plain version for CPU tensors, the CUDA
kernel for CUDA tensors (or an error), and the kernel's launch count.

Unlike the JAX wrapper, nothing is padded or transposed: the kernel reads the
model's (B, S, H, D) layout through strides and masks ragged lengths itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import flash_attention_ref

HEAD_DIMS = (64, 128)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_positions: torch.Tensor, kv_positions: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, KV, D); positions (B, S*) or (S*,)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, q_positions, kv_positions,
                                   causal=causal, window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if k.shape != (B, Skv, KV, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if H % KV:
        raise ValueError(f"flash_attention: {H} heads not a multiple of {KV} kv heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.device != q.device for t in (k, v, q_positions, kv_positions)):
        raise ValueError("flash_attention: inputs on different devices")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim must be dense")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]) for t in (q, k, v)):
        raise ValueError("flash_attention: bf16 rows must be 16-byte aligned "
                         "(strides multiples of 8 elements)")
    if not isinstance(window, int):
        raise TypeError("flash_attention: window must be a Python int")
    q_pos = torch.broadcast_to(q_positions, (B, Sq)).to(torch.int32).contiguous()
    kv_pos = torch.broadcast_to(kv_positions, (B, Skv)).to(torch.int32).contiguous()
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    out = flash_attention_cuda(q, k, v, q_pos, kv_pos, causal=causal,
                               window=window, softcap=softcap)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
