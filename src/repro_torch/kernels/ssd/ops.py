"""SSD dispatch: the plain version for CPU tensors, the CUDA kernel for CUDA
tensors (or an error), and the kernel's launch count.

The chunk length follows the JAX wrapper: ``cl = min(chunk, round_up(L, 8))``.
Unlike the JAX wrapper, nothing is padded: the kernel masks the ragged tail
itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd.ref import ssd_ref
from repro_torch.utils import round_up

#: (P, N) head and state sizes the kernel is built for: the full configs
#: and the smoke configs
SHAPES = ((64, 128), (16, 16))
MAX_CHUNK = 256


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, *, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, L, H, P); dt (B, L, H) fp32, softplus'd; A (H,) fp32 < 0;
    Bm, Cm (B, L, G, N). Returns (y (B, L, H, P) in x's dtype, the fp32
    final state (B, H, P, N))."""
    B, L, H, P = x.shape
    cl = min(chunk, round_up(L, 8))
    if x.device.type == "cpu":
        return ssd_ref(x, dt, A, Bm, Cm, chunk=cl)
    if x.device.type != "cuda":
        raise ValueError(f"ssd: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, Bm, Cm)):
        raise NotImplementedError("ssd: the SSD kernel has no backward yet (ROADMAP "
                                  "Queue 1 item 16: SSD backward and mamba training)")
    G, N = Bm.shape[-2:]
    if L == 0:
        raise ValueError("ssd: empty sequence")
    if dt.shape != (B, L, H) or A.shape != (H,) \
            or Bm.shape != (B, L, G, N) or Cm.shape != Bm.shape:
        raise ValueError(f"ssd: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(Bm.shape)}, "
                         f"C {tuple(Cm.shape)} do not agree")
    if H % G:
        raise ValueError(f"ssd: {H} heads not a multiple of {G} groups")
    if (P, N) not in SHAPES:
        raise ValueError(f"ssd: (P, N) = {(P, N)} not in {SHAPES}")
    if cl > MAX_CHUNK:
        raise ValueError(f"ssd: chunk {cl} > {MAX_CHUNK}")
    if x.dtype not in (torch.float32, torch.bfloat16) or Bm.dtype != x.dtype \
            or Cm.dtype != x.dtype:
        raise TypeError(f"ssd: dtypes x {x.dtype}, B {Bm.dtype}, C {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd: dt and A must be float32, got {dt.dtype}, {A.dtype}")
    if any(t.device != x.device for t in (dt, A, Bm, Cm)):
        raise ValueError("ssd: inputs on different devices")
    if not all(t.is_contiguous() for t in (x, dt, A, Bm, Cm)):
        raise ValueError("ssd: inputs must be contiguous")
    if x.dtype == torch.bfloat16 and (cl % 8 or any(t.data_ptr() % 16 for t in (x, Bm, Cm))):
        raise ValueError(f"ssd: bf16 needs a chunk length that is a multiple of 8 "
                         f"(got {cl}) and 16-byte aligned x, B, C")
    from repro_torch.kernels.ssd.kernel import ssd_cuda
    out = ssd_cuda(x, dt, A, Bm, Cm, cl)
    ssd.launches += 1
    return out


ssd.launches = 0
