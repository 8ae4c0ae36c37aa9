"""ctypes bindings of ``csrc/flash_attention.cu`` (the forward) and
``csrc/flash_attention_bwd.cu`` (the backward); see the sources for the
kernels' design. The libraries are built at first use by
:mod:`repro_torch.kernels.build`; importing this module builds nothing."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_FNS: dict = {}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _fn(name: str):
    fn = _FNS.get(name)
    if fn is None:
        if name == "flash_attention_bwd":
            fn = build.load("flash_attention_bwd").flash_attention_bwd
            fn.argtypes = [_P] * 12 + [_I] * 9 + [_F, _F, _P]
        else:
            fn = getattr(build.load("flash_attention"), name)
            lse = [_P] if name == "flash_attention_fwd_lse" else []
            fn.argtypes = ([_P] * 6 + lse                       # q k v q_pos kv_pos o [lse]
                           + [_I] * 7                           # B Sq Skv H KV D dtype
                           + [ctypes.POINTER(ctypes.c_longlong)]  # strides
                           + [_I, _I, _F, _F, _P])              # causal window scale softcap stream
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                         causal: bool, window: int, softcap: float,
                         with_lse: bool = False):
    """Launch on checked CUDA tensors: q (B,Sq,H,D), k/v (B,Skv,KV,D) with a
    dense last dim (bf16: 16-byte aligned rows), int32 contiguous positions
    (B,Sq)/(B,Skv). Returns (out, lse): out a new contiguous (B,Sq,H,D)
    tensor in q's dtype; lse (B,H,Sq) fp32 with ``with_lse`` (the entry
    ``flash_attention_fwd_lse``), else None (``flash_attention_fwd``, the
    serving kernel, which writes no LSE)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2))
    head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), out.data_ptr()]
    tail = [B, Sq, Skv, H, KV, D, _DTYPES[q.dtype], strides, int(causal), int(window),
            D ** -0.5, float(softcap), torch.cuda.current_stream(q.device).cuda_stream]
    lse = None
    if with_lse:
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        err = _fn("flash_attention_fwd_lse")(*head, lse.data_ptr(), *tail)
    else:
        err = _fn("flash_attention_fwd")(*head, *tail)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {err}")
    return out, lse


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, q_pos, kv_pos, *,
                             causal: bool, window: int, softcap: float):
    """Launch the backward on checked, dense CUDA tensors (q, out, dout
    (B,Sq,H,D); k, v (B,Skv,KV,D); lse (B,H,Sq) fp32; int32 positions).
    Returns new (dq, dk, dv) in q's dtype."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    err = _fn("flash_attention_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), B, Sq, Skv, H, KV, D,
        _DTYPES[q.dtype], int(causal), int(window), D ** -0.5, float(softcap),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error {err}")
    return dq, dk, dv
