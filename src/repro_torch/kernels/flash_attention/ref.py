"""Plain PyTorch attention with the flash kernels' semantics, forward and
backward: the CPU path and the kernels' yardstick on the card.

Materializes the whole (Sq, Skv) score matrix in fp32: O(S^2) memory.
"""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30


def _scores(q, k, q_positions, kv_positions, causal, window, softcap):
    """fp32 scores (B, KV, G, Sq, Skv) after the soft-cap, the tanh of the
    soft-cap (or None), and the visibility mask."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * (D ** -0.5)
    t = None
    if softcap:
        t = torch.tanh(s / softcap)
        s = t * softcap
    q_pos = torch.broadcast_to(q_positions, (B, Sq))[:, None, None, :, None]
    kv_pos = torch.broadcast_to(kv_positions, (B, Skv))[:, None, None, None, :]
    ok = kv_pos >= 0
    if causal:
        ok = ok & (kv_pos <= q_pos)
    if window > 0:
        ok = ok & ((q_pos - kv_pos) < window)
    return s, t, ok


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_positions: torch.Tensor, kv_positions: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, return_lse: bool = False):
    """Model layout: q (B, Sq, H, D); k, v (B, Skv, KV, D); positions
    (B, S*) or (S*,). Everything in fp32, output in q's dtype. With
    ``return_lse``, also the per-row log-sum-exp of the visible scores,
    (B, H, Sq) fp32, +inf for a row that sees nothing (the kernels' LSE)."""
    B, Sq, H, D = q.shape
    s, _, ok = _scores(q, k, q_positions, kv_positions, causal, window, softcap)
    s = torch.where(ok, s, NEG_INF)
    p = torch.where(ok, torch.softmax(s, dim=-1), 0.0)   # masked rows -> 0
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    out = out.reshape(B, Sq, H, D).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(torch.where(ok, s, -torch.inf), dim=-1)
    lse = torch.where(ok.any(dim=-1), lse, torch.inf)
    return out, lse.reshape(B, H, Sq)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, q_positions, kv_positions,
                            *, causal: bool = True, window: int = 0,
                            softcap: float = 0.0, delta=None):
    """The gradient of :func:`flash_attention_ref` as the backward kernel
    computes it, written out in fp32 from the forward's ``out`` and ``lse``
    (B, H, Sq): P = exp(s - lse) on visible pairs, delta = rowsum(dO * out),
    dS = P (dO V^T - delta) (times 1 - tanh^2 under a soft-cap); dV = P^T dO,
    dK = scale dS^T Q, dQ = scale dS K. ``delta`` (B, H, Sq) replaces the
    row sums when given. Returns (dq, dk, dv) in the inputs' dtypes."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = D ** -0.5
    s, t, ok = _scores(q, k, q_positions, kv_positions, causal, window, softcap)
    lse = lse.float().reshape(B, KV, G, Sq)[..., None]
    p = torch.where(ok, torch.exp(s - lse), 0.0)
    do = dout.float().reshape(B, Sq, KV, G, D)
    if delta is None:
        delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1)    # (B, H, Sq)
    dp = torch.einsum("bqkgd,bskd->bkgqs", do, v.float())
    ds = p * (dp - delta.float().reshape(B, KV, G, Sq)[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds,
                      q.reshape(B, Sq, KV, G, D).float()) * scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, do)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
