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
                       p, p, p,                    # scratch: cb cum states
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
    y (B, L, H, P) in x's dtype and the fp32 final state (B, H, P, N).

    bf16 runs four kernels (see the source) that pass fp32 scratch from one
    to the next: C·Bᵀ per group (B, G, nc, cl, cl), the within-chunk cumsum
    (B, H, nc, cl) and the chunk states (B, nc, H, P, N)."""
    B, L, H, P = x.shape
    G, N = Bm.shape[-2:]
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    scratch = (None, None, None)
    if x.dtype == torch.bfloat16:
        nc = -(-L // cl)
        f32 = dict(dtype=torch.float32, device=x.device)
        cb = torch.empty((B, G, nc, cl, cl), **f32)
        cum = torch.empty((B, H, nc, cl), **f32)
        states = torch.empty((B, nc, H, P, N), **f32)
        scratch = (cb.data_ptr(), cum.data_ptr(), states.data_ptr())
    err = _fn()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), state.data_ptr(), *scratch,
                B, L, H, P, G, N, cl, _DTYPES[x.dtype],
                torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_fwd launch failed: CUDA error {err}")
    return y, state
