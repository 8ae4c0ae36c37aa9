"""ctypes binding of ``csrc/flash_attention.cu`` (see the source for the
kernel's design). The library is built at first use by
:mod:`repro_torch.kernels.build`; importing this module builds nothing."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_FN = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _fn():
    global _FN
    if _FN is None:
        fn = build.load("flash_attention").flash_attention_fwd
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p,                  # q k v q_pos kv_pos o
                       i, i, i, i, i, i, i,               # B Sq Skv H KV D dtype
                       ctypes.POINTER(ctypes.c_longlong),  # strides
                       i, i, f, f, p]                     # causal window scale softcap stream
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                         causal: bool, window: int, softcap: float) -> torch.Tensor:
    """Launch on checked CUDA tensors: q (B,Sq,H,D), k/v (B,Skv,KV,D) with a
    dense last dim (bf16: 16-byte aligned rows), int32 contiguous positions
    (B,Sq)/(B,Skv). Returns a new contiguous (B,Sq,H,D) tensor in q's dtype."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2))
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
                kv_pos.data_ptr(), out.data_ptr(), B, Sq, Skv, H, KV, D,
                _DTYPES[q.dtype], strides, int(causal), int(window),
                D ** -0.5, float(softcap),
                torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {err}")
    return out
