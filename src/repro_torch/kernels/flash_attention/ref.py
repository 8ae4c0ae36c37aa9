"""Plain PyTorch attention with the flash kernel's semantics: the CPU path and
the kernel's yardstick on the card.

Materializes the whole (Sq, Skv) score matrix in fp32: O(S^2) memory.
"""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_positions: torch.Tensor, kv_positions: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """Model layout: q (B, Sq, H, D); k, v (B, Skv, KV, D); positions
    (B, S*) or (S*,). Everything in fp32, output in q's dtype."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, D).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * (D ** -0.5)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    q_pos = torch.broadcast_to(q_positions, (B, Sq))[:, None, None, :, None]
    kv_pos = torch.broadcast_to(kv_positions, (B, Skv))[:, None, None, None, :]
    ok = kv_pos >= 0
    if causal:
        ok = ok & (kv_pos <= q_pos)
    if window > 0:
        ok = ok & ((q_pos - kv_pos) < window)
    s = torch.where(ok, s, NEG_INF)
    p = torch.where(ok, torch.softmax(s, dim=-1), 0.0)   # masked rows -> 0
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)
