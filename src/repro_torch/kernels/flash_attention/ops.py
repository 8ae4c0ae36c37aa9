"""Flash-attention dispatch: the plain versions for CPU tensors, the CUDA
kernels for CUDA tensors (or an error), and the kernels' launch counts.

Unlike the JAX wrapper, nothing is padded or transposed: the forward kernel
reads the model's (B, S, H, D) layout through strides and masks ragged
lengths itself.

Where autograd needs a gradient of q, k or v, :func:`flash_attention` goes
through a ``torch.autograd.Function``: its forward launches the kernel's
LSE-writing entry and keeps (q, k, v, out, lse) for :func:`flash_attention_bwd`.
Otherwise (serving, ``torch.no_grad()``) it launches the serving entry,
which writes no LSE.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)

HEAD_DIMS = (64, 128)


def _check(q, k, v, q_positions, kv_positions, window) -> None:
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


def _positions(q, k, q_positions, kv_positions):
    B, Sq, Skv = q.shape[0], q.shape[1], k.shape[1]
    return (torch.broadcast_to(q_positions, (B, Sq)).to(torch.int32).contiguous(),
            torch.broadcast_to(kv_positions, (B, Skv)).to(torch.int32).contiguous())


def _forward(q, k, v, q_positions, kv_positions, causal, window, softcap,
             with_lse: bool):
    """(out, lse or None): the plain version on the CPU, else the kernel."""
    if q.device.type == "cpu":
        res = flash_attention_ref(q, k, v, q_positions, kv_positions, causal=causal,
                                  window=window, softcap=softcap, return_lse=with_lse)
        return res if with_lse else (res, None)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v, q_positions, kv_positions, window)
    q_pos, kv_pos = _positions(q, k, q_positions, kv_positions)
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    res = flash_attention_cuda(q, k, v, q_pos, kv_pos, causal=causal, window=window,
                               softcap=softcap, with_lse=with_lse)
    flash_attention.launches += 1
    flash_attention.lse_launches += with_lse
    return res


def flash_attention_with_lse(q, k, v, q_positions, kv_positions, *, causal: bool = True,
                             window: int = 0, softcap: float = 0.0):
    """(out, lse): the training forward, which also writes the per-row
    log-sum-exp (B, H, Sq) fp32 that :func:`flash_attention_bwd` needs."""
    return _forward(q, k, v, q_positions, kv_positions, causal, window, softcap,
                    with_lse=True)


def flash_attention_bwd(q, k, v, out, lse, dout, q_positions, kv_positions, *,
                        causal: bool = True, window: int = 0, softcap: float = 0.0):
    """(dq, dk, dv) of :func:`flash_attention` given its ``out`` and ``lse``:
    the plain gradient on the CPU, else the backward kernel (or an error)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, q_positions,
                                       kv_positions, causal=causal, window=window,
                                       softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    _check(q, k, v, q_positions, kv_positions, window)
    q, k, v, out, dout = (t.contiguous() for t in (q, k, v, out, dout))
    if out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype \
            or dout.dtype != q.dtype:
        raise ValueError("flash_attention_bwd: out and dout must be shaped and typed as q")
    if lse.shape != (q.shape[0], q.shape[2], q.shape[1]) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} {lse.dtype}")
    if any(t.device != q.device or t.data_ptr() % 16 for t in (out, dout, lse)) or \
            any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_bwd: inputs must be 16-byte aligned, on one device")
    q_pos, kv_pos = _positions(q, k, q_positions, kv_positions)
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd_cuda
    grads = flash_attention_bwd_cuda(q, k, v, out, lse.contiguous(), dout, q_pos,
                                     kv_pos, causal=causal, window=window,
                                     softcap=softcap)
    flash_attention_bwd.launches += 1
    return grads


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, causal, window, softcap):
        out, lse = flash_attention_with_lse(q, k, v, q_positions, kv_positions,
                                            causal=causal, window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v, out, lse, q_positions, kv_positions)
        ctx.mask = (causal, window, softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_positions, kv_positions = ctx.saved_tensors
        causal, window, softcap = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, q_positions,
                                         kv_positions, causal=causal, window=window,
                                         softcap=softcap)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_positions: torch.Tensor, kv_positions: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, KV, D); positions (B, S*) or (S*,)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, q_positions, kv_positions, causal,
                                     window, softcap)
    return _forward(q, k, v, q_positions, kv_positions, causal, window, softcap,
                    with_lse=False)[0]


flash_attention.launches = 0          # forward launches, both entries
flash_attention.lse_launches = 0      # of which the LSE-writing entry
flash_attention_bwd.launches = 0
