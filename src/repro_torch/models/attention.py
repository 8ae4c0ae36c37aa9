"""Attention: GQA (with sliding windows and local:global) and MLA
(DeepSeek-v2), each with its decode cache.

Full-sequence attention (prefill, forward) goes through the flash-attention
kernel (:mod:`repro_torch.kernels.flash_attention`); one-token decode is
plain PyTorch over the cache, as in the JAX package (``attention_ref``, and
MLA's absorbed-weight decode). Cache slots carry absolute positions, so
full, sliding-window and local:global layers are uniform: validity is a
predicate on slot position, and a slot with position < 0 is empty.

The decode paths update the cache in place instead of returning a copy:
the cache at full context is gigabytes, and nothing reads the old one.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.config import AttentionConfig
from repro_torch.kernels.flash_attention import flash_attention as flash_kernel
from repro_torch.models.layers import apply_rope, rmsnorm
from repro_torch.models.spec import ParamSpec

Params = Any
NEG_INF = -2.0 ** 30  # large-but-finite; avoids NaNs for fully-masked rows


def attn_specs(cfg: AttentionConfig, d_model: int) -> dict:
    s = d_model ** -0.5
    if cfg.kind == "mla":
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        specs = {
            "w_dkv": ParamSpec((d_model, cfg.kv_lora_rank + cfg.qk_rope_dim),
                               ("embed", None), stddev=s),
            "kv_norm": ParamSpec((cfg.kv_lora_rank,), (None,), init="ones"),
            "w_uk": ParamSpec((cfg.kv_lora_rank, cfg.num_heads, cfg.qk_nope_dim),
                              (None, "heads", None),
                              stddev=cfg.kv_lora_rank ** -0.5),
            "w_uv": ParamSpec((cfg.kv_lora_rank, cfg.num_heads, cfg.v_head_dim),
                              (None, "heads", None),
                              stddev=cfg.kv_lora_rank ** -0.5),
            "wo": ParamSpec((cfg.num_heads, cfg.v_head_dim, d_model),
                            ("heads", None, "embed"),
                            stddev=(cfg.num_heads * cfg.v_head_dim) ** -0.5),
        }
        if cfg.q_lora_rank:
            specs["w_dq"] = ParamSpec((d_model, cfg.q_lora_rank),
                                      ("embed", None), stddev=s)
            specs["q_norm"] = ParamSpec((cfg.q_lora_rank,), (None,), init="ones")
            specs["w_uq"] = ParamSpec((cfg.q_lora_rank, cfg.num_heads, qk),
                                      (None, "heads", None),
                                      stddev=cfg.q_lora_rank ** -0.5)
        else:
            specs["wq"] = ParamSpec((d_model, cfg.num_heads, qk),
                                    ("embed", "heads", None), stddev=s)
        return specs
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


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-v2)
# ---------------------------------------------------------------------------

def _mla_q(params: Params, cfg: AttentionConfig, x: torch.Tensor, positions,
           dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(q_nope, q_rope), each (B, S, H, *); RoPE on the rope part."""
    if cfg.q_lora_rank:
        cq = rmsnorm({"scale": params["q_norm"]}, x @ params["w_dq"].to(dtype))
        q = _proj_heads(cq, params["w_uq"], dtype)
    else:
        q = _proj_heads(x, params["wq"], dtype)
    q_nope = q[..., :cfg.qk_nope_dim]
    q_rope = apply_rope(q[..., cfg.qk_nope_dim:], positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_latent(params: Params, cfg: AttentionConfig, x: torch.Tensor, positions,
                dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(ckv (B, S, kv_lora_rank) after its RMSNorm, k_rope (B, S, rope))."""
    dkv = x @ params["w_dkv"].to(dtype)
    # the RMSNorm kernel takes dense rows: the latent half as its own tensor
    ckv = rmsnorm({"scale": params["kv_norm"]}, dkv[..., :cfg.kv_lora_rank].contiguous())
    k_rope = apply_rope(dkv[..., None, cfg.kv_lora_rank:], positions,
                        cfg.rope_theta)[..., 0, :]
    return ckv, k_rope


def mla_forward(params: Params, cfg: AttentionConfig, x: torch.Tensor,
                positions: torch.Tensor, *, dtype) -> torch.Tensor:
    """Training/prefill MLA: decompress the latent to per-head K/V and run
    flash attention at head dim qk_nope + qk_rope (192 for deepseek-v2),
    with v zero-padded to it as the reference pads it, then sliced back.
    q, k and v are built by ``torch.cat``/``F.pad``: dense (B, S, H, qk)
    tensors, as the kernel's TMA maps want them."""
    B, S, _ = x.shape
    H = cfg.num_heads
    q_nope, q_rope = _mla_q(params, cfg, x, positions, dtype)
    ckv, k_rope = _mla_latent(params, cfg, x, positions, dtype)
    k_nope = _proj_heads(ckv, params["w_uk"], dtype)
    v = _proj_heads(ckv, params["w_uv"], dtype)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, cfg.qk_rope_dim)], dim=-1)
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    v_p = torch.nn.functional.pad(v, (0, qk - cfg.v_head_dim))
    out = flash_attention(q, k, v_p, q_positions=positions, kv_positions=positions,
                          window=0, causal=True)
    return _out_proj(out[..., :cfg.v_head_dim], params["wo"], dtype)


def mla_cache_init(cfg: AttentionConfig, batch: int, cache_len: int, dtype,
                   device: torch.device | str = "cpu") -> dict:
    return {
        "ckv": torch.zeros((batch, cache_len, cfg.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, cache_len, cfg.qk_rope_dim), dtype=dtype,
                              device=device),
        "pos": torch.full((batch, cache_len), -1, dtype=torch.int32, device=device),
    }


def mla_prefill_cache(params: Params, cfg: AttentionConfig, x: torch.Tensor,
                      positions: torch.Tensor, cache_len: int, dtype) -> dict:
    """The latent cache of a prompt of length S: its last min(S, cache_len)
    tokens in the first slots, as the reference writes them (no ring roll)."""
    B, S, _ = x.shape
    ckv, k_rope = _mla_latent(params, cfg, x, positions, dtype)
    pos = torch.broadcast_to(positions, (B, S)).to(torch.int32)
    cache = mla_cache_init(cfg, B, cache_len, dtype, x.device)
    n = min(S, cache_len)
    cache["ckv"][:, :n] = ckv[:, -n:]
    cache["k_rope"][:, :n] = k_rope[:, -n:]
    cache["pos"][:, :n] = pos[:, -n:]
    return cache


def mla_decode(params: Params, cfg: AttentionConfig, x: torch.Tensor, cache: dict,
               cur_index: int, *, dtype) -> tuple[torch.Tensor, dict]:
    """Absorbed-weight decode: attend in the kv_lora_rank-wide latent space
    directly (w_uk folded into the query, w_uv applied after the softmax),
    so no per-head K/V is materialized. Plain PyTorch, as the reference's is
    plain jnp. Writes the new latent, rope key and position into ``cache``
    in place."""
    B = x.shape[0]
    cache_len = cache["ckv"].shape[1]
    pos = torch.full((B, 1), cur_index, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(params, cfg, x, pos, dtype)            # (B,1,H,*)
    ckv_new, k_rope_new = _mla_latent(params, cfg, x, pos, dtype)
    slot = cur_index % cache_len
    cache["ckv"][:, slot] = ckv_new[:, 0].to(cache["ckv"].dtype)
    cache["k_rope"][:, slot] = k_rope_new[:, 0].to(cache["k_rope"].dtype)
    cache["pos"][:, slot] = cur_index
    # As in gqa_decode, slots past cur_index are empty or hold positions the
    # mask hides, so the first min(cur_index + 1, cache_len) slots suffice.
    n = min(cur_index + 1, cache_len)
    ckv = cache["ckv"][:, :n].to(dtype)
    # absorb w_uk into the query: q_lat[b, 1, h, r]
    q_lat = torch.einsum("bqhk,rhk->bqhr", q_nope, params["w_uk"].to(dtype))
    s = (torch.einsum("bqhr,bsr->bhqs", q_lat.float(), ckv.float())
         + torch.einsum("bqhk,bsk->bhqs", q_rope.float(),
                        cache["k_rope"][:, :n].to(dtype).float()))
    s = s * ((cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5)
    kv_pos = cache["pos"][:, None, None, :n]                          # (B,1,1,n)
    ok = (kv_pos >= 0) & (kv_pos <= cur_index)
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhqs,bsr->bqhr", p.to(dtype), ckv)
    out = torch.einsum("bqhr,rhv->bqhv", ctx, params["w_uv"].to(dtype))
    return _out_proj(out, params["wo"], dtype), cache
