"""GQA attention with sliding windows and a ring-buffer KV cache.

Full-sequence attention (prefill, forward) goes through the flash-attention
kernel (:mod:`repro_torch.kernels.flash_attention`); one-token decode is
plain PyTorch over the cache, as in the JAX package (``attention_ref``).
Cache slots carry absolute positions, so full, sliding-window and
local:global layers are uniform: validity is a predicate on slot position,
and a slot with position < 0 is empty.

The decode path updates the cache in place instead of returning a copy:
the cache at full context is gigabytes, and nothing reads the old one.
MLA (DeepSeek-v2) waits for a later slice (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.config import AttentionConfig
from repro_torch.kernels.flash_attention import flash_attention as flash_kernel
from repro_torch.models.layers import apply_rope
from repro_torch.models.spec import ParamSpec

Params = Any
NEG_INF = -2.0 ** 30  # large-but-finite; avoids NaNs for fully-masked rows


def attn_specs(cfg: AttentionConfig, d_model: int) -> dict:
    if cfg.kind != "gqa":
        raise NotImplementedError(
            f"attention kind {cfg.kind!r}: MLA is ROADMAP Queue 1 item 10")
    s = d_model ** -0.5
    return {
        "wq": ParamSpec((d_model, cfg.num_heads, cfg.head_dim),
                        ("embed", "heads", None), stddev=s),
        "wk": ParamSpec((d_model, cfg.num_kv_heads, cfg.head_dim),
                        ("embed", "kv_heads", None), stddev=s),
        "wv": ParamSpec((d_model, cfg.num_kv_heads, cfg.head_dim),
                        ("embed", "kv_heads", None), stddev=s),
        "wo": ParamSpec((cfg.num_heads, cfg.head_dim, d_model),
                        ("heads", None, "embed"),
                        stddev=(cfg.num_heads * cfg.head_dim) ** -0.5),
    }


def _mask(q_pos, k_pos, window: int, causal: bool) -> torch.Tensor:
    """Validity of (q, k) pairs. Positions < 0 are empty slots."""
    valid = k_pos >= 0
    if causal:
        valid = valid & (k_pos <= q_pos)
    if window > 0:
        valid = valid & (q_pos - k_pos < window)
    return valid


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_positions: torch.Tensor, kv_positions: torch.Tensor,
                    window: int = 0, causal: bool = True,
                    softcap: float = 0.0) -> torch.Tensor:
    """Dispatch to the flash-attention wrapper: the CUDA kernel on the card,
    its plain version on the CPU. q: (B, Sq, H, D); k, v: (B, Skv, KV, D)."""
    return flash_kernel(q, k, v, q_positions, kv_positions, causal=causal,
                        window=window, softcap=softcap)


def attention_ref(q, k, v, *, q_positions, kv_positions, window: int = 0,
                  causal: bool = True, softcap: float = 0.0) -> torch.Tensor:
    """O(S^2)-memory attention: scores in fp32, probabilities cast to v's
    dtype before the value product (the reference's decode numerics)."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qb = q.reshape(B, Sq, KV, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qb.float(), k.float()) * (D ** -0.5)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    q_pos = torch.broadcast_to(q_positions, (B, Sq))
    kv_pos = torch.broadcast_to(kv_positions, (B, k.shape[1]))
    ok = _mask(q_pos[:, None, None, :, None], kv_pos[:, None, None, None, :],
               window, causal)
    s = torch.where(ok, s, NEG_INF)
    p = torch.where(ok, torch.softmax(s, dim=-1), 0.0)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
    return out.reshape(B, Sq, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA module
# ---------------------------------------------------------------------------

def _proj_heads(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, h, k = w.shape
    return (x @ w.to(dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _out_proj(o: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matrix product."""
    h, k, d = w.shape
    return o.flatten(-2) @ w.to(dtype).reshape(h * k, d)


def gqa_forward(params: Params, cfg: AttentionConfig, x: torch.Tensor,
                positions: torch.Tensor, *, window: int, dtype,
                causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (forward / prefill). x: (B, S, d)."""
    q = _proj_heads(x, params["wq"], dtype)
    k = _proj_heads(x, params["wk"], dtype)
    v = _proj_heads(x, params["wv"], dtype)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = flash_attention(q, k, v, q_positions=positions,
                          kv_positions=positions, window=window,
                          causal=causal, softcap=cfg.logit_softcap)
    return _out_proj(out, params["wo"], dtype)


# --- KV cache (ring buffer with absolute slot positions) -------------------

def gqa_cache_init(cfg: AttentionConfig, batch: int, cache_len: int,
                   dtype, device: torch.device | str = "cpu") -> dict:
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((batch, cache_len), -1, dtype=torch.int32, device=device),
    }


def gqa_prefill_cache(params: Params, cfg: AttentionConfig, x: torch.Tensor,
                      positions: torch.Tensor, cache_len: int, dtype) -> dict:
    """Build a cache from a prompt of length S (ring-rotated if S >= len)."""
    B, S, _ = x.shape
    k = _proj_heads(x, params["wk"], dtype)
    v = _proj_heads(x, params["wv"], dtype)
    if cfg.use_rope:
        k = apply_rope(k, positions, cfg.rope_theta)
    pos = torch.broadcast_to(positions, (B, S)).to(torch.int32)
    if S >= cache_len:
        k, v, pos = k[:, -cache_len:], v[:, -cache_len:], pos[:, -cache_len:]
        shift = S % cache_len
        return {"k": torch.roll(k, shift, dims=1),
                "v": torch.roll(v, shift, dims=1),
                "pos": torch.roll(pos, shift, dims=1)}
    cache = gqa_cache_init(cfg, B, cache_len, dtype, x.device)
    cache["k"][:, :S] = k
    cache["v"][:, :S] = v
    cache["pos"][:, :S] = pos
    return cache


def gqa_decode(params: Params, cfg: AttentionConfig, x: torch.Tensor,
               cache: dict, cur_index: int, *, window: int,
               dtype) -> tuple[torch.Tensor, dict]:
    """One-token decode. x: (B, 1, d); cur_index: absolute position.

    Writes the new key, value and position into ``cache`` in place."""
    B = x.shape[0]
    cache_len = cache["k"].shape[1]
    pos = torch.full((B, 1), cur_index, dtype=torch.int32, device=x.device)
    q = _proj_heads(x, params["wq"], dtype)
    k = _proj_heads(x, params["wk"], dtype)
    v = _proj_heads(x, params["wv"], dtype)
    if cfg.use_rope:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    slot = cur_index % cache_len
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][:, slot] = cur_index
    # A slot holds position p at index p % cache_len, so a slot at index
    # > cur_index is empty or holds a future position, which the causal
    # mask hides. Attending over the first min(cur_index + 1, cache_len)
    # slots therefore gives the same result as the whole ring (which the
    # JAX package attends over) at a cost that grows with the context, not
    # with the cache's capacity.
    n = min(cur_index + 1, cache_len)
    out = attention_ref(q, cache["k"][:, :n].to(dtype), cache["v"][:, :n].to(dtype),
                        q_positions=pos, kv_positions=cache["pos"][:, :n],
                        window=window, causal=True,
                        softcap=cfg.logit_softcap)
    return _out_proj(out, params["wo"], dtype), cache
