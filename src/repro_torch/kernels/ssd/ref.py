"""Plain PyTorch SSD chunked scan (Mamba2, arXiv:2405.21060): the CPU path and
the CUDA kernel's yardstick on the card.

The math of ``repro.models.mamba.ssd_chunked``: L padded to a chunk multiple
with ``dt = 0`` rows (no-op steps), an intra-chunk quadratic term, chunk
states and the inter-chunk recurrence, all in fp32. A Python loop over
chunks replaces the reference's ``associative_scan``: it is the same
recurrence ``T_n = a_n T_{n-1} + S_n``. The reference's ``head_block`` is a
memory device of its jnp path that leaves the numbers as they are; there is
no copy of it here.

Materializes (b, nc, cl, cl, H) fp32 tensors: O(L * cl * H) memory.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def chunk_cumsum(dA: torch.Tensor, dim: int) -> torch.Tensor:
    """Within-chunk prefix sum of fp32 ``dA``, accumulated in fp64 and rounded
    to fp32 once per element: the CPU's ``cumsum`` of fp32 does the same, and
    so does the CUDA kernel, so both sides get the same ``cum`` whatever order
    their additions take. ``exp(cum_i - cum_j)`` amplifies a rounding
    difference in ``cum`` by ``|cum|``, which reaches the hundreds late in a
    256-row chunk."""
    return torch.cumsum(dA.double(), dim=dim).float()


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
            initial_state: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (b, L, H, P); dt (b, L, H), already softplus'd (>= 0); A (H,) < 0;
    Bm, Cm (b, L, G, N) with H % G == 0; initial_state (b, H, P, N) or None.

    Returns (y (b, L, H, P) in x's dtype, final state (b, H, P, N) fp32)."""
    b, L, H, P = x.shape
    G, N = Bm.shape[-2:]
    rep = H // G
    cl = min(chunk, L)
    nc = -(-L // cl)
    pad = nc * cl - L
    f32 = torch.float32
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))                 # dt = 0: no-op steps
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    xc = x.reshape(b, nc, cl, H, P).to(f32)
    dtc = dt.reshape(b, nc, cl, H).to(f32)
    Bc = Bm.reshape(b, nc, cl, G, N).to(f32)
    Cc = Cm.reshape(b, nc, cl, G, N).to(f32)

    dA = dtc * A.to(f32)                                # (b, nc, cl, H), <= 0
    cum = chunk_cumsum(dA, dim=2)
    # intra-chunk: decay from step j to step i (i >= j), masked INSIDE the
    # exp: above the diagonal seg > 0 can overflow
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (b,nc,i,j,H)
    tri = torch.tril(torch.ones((cl, cl), dtype=torch.bool, device=x.device))
    Lmat = torch.exp(torch.where(tri[None, None, :, :, None], seg,
                                 torch.tensor(-torch.inf, device=x.device)))
    scores = torch.einsum("bcign,bcjgn->bcijg", Cc, Bc)
    scores = torch.repeat_interleave(scores, rep, dim=-1)      # g -> h
    W = scores * Lmat * dtc[:, :, None, :, :]                  # (b,nc,i,j,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", W, xc)

    # chunk states (b, nc, H, P, N)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)          # (b,nc,j,H)
    Bh = torch.repeat_interleave(Bc, rep, dim=3)               # (b,nc,cl,H,N)
    S = torch.einsum("bcjh,bcjhn,bcjhp->bchpn", decay_to_end * dtc, Bh, xc)

    # inter-chunk recurrence; R[:, n] is the state entering chunk n
    a = torch.exp(cum[:, :, -1, :])                            # (b, nc, H)
    T = (initial_state.to(f32) if initial_state is not None
         else torch.zeros((b, H, P, N), dtype=f32, device=x.device))
    R = []
    for n in range(nc):
        R.append(T)
        T = a[:, n, :, None, None] * T + S[:, n]
    R = torch.stack(R, dim=1)                                  # (b,nc,H,P,N)

    Ch = torch.repeat_interleave(Cc, rep, dim=3)               # (b,nc,cl,H,N)
    y_inter = torch.einsum("bcihn,bcih,bchpn->bcihp", Ch, torch.exp(cum), R)
    y = (y_intra + y_inter).reshape(b, nc * cl, H, P)[:, :L]
    return y.to(x.dtype), T
