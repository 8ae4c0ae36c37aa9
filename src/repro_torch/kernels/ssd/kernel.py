"""ctypes binding of ``csrc/ssd.cu`` (see the source for the kernel's
design). The library is built at first use by
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
        fn = build.load("ssd").ssd_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p,        # x dt A Bm Cm y state
                       i, i, i, i, i, i, i, i,     # B L H P G N cl dtype
                       p]                          # stream
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, cl: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch on checked contiguous CUDA tensors: x (B, L, H, P), Bm/Cm
    (B, L, G, N) in one dtype, dt (B, L, H) and A (H,) fp32. Returns new
    y (B, L, H, P) in x's dtype and the fp32 final state (B, H, P, N)."""
    B, L, H, P = x.shape
    G, N = Bm.shape[-2:]
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    err = _fn()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
                B, L, H, P, G, N, cl, _DTYPES[x.dtype],
                torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_fwd launch failed: CUDA error {err}")
    return y, state
