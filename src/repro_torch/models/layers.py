"""Core layers: norms, MLPs, embeddings, rotary embeddings, the loss.

Each layer is a (specs, apply) pair of plain functions over dicts of tensors,
as in ``repro.models.layers``, with the same numerics: parameters are stored
in fp32 and used in the compute dtype, RMSNorm runs in fp32, RoPE runs in
fp32 on split halves. The model casts the weights to the compute dtype once
(``Model.load_params``), so the apply functions below receive them already
cast; the ``.to(dtype)`` calls are then no-ops.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels.rmsnorm import rmsnorm as rmsnorm_kernel
from repro_torch.models.spec import ParamSpec

Params = Any


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_specs(dim: int) -> dict:
    return {"scale": ParamSpec((dim,), ("embed",), init="ones")}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """fp32 RMSNorm cast back to ``x.dtype``: the Triton kernel on the card,
    its plain version on the CPU. The scale is read in fp32 (a no-op for the
    fp32 leaves; a bf16 cast of them, under ``grad_dtype="bfloat16"``, is
    widened as the reference widens it)."""
    return rmsnorm_kernel(x, params["scale"].float(), eps)


# ---------------------------------------------------------------------------
# MLP (dense FFN)
# ---------------------------------------------------------------------------

def mlp_specs(d_model: int, d_ff: int, act: str) -> dict:
    glu = act.endswith("_glu")
    specs = {
        "w1": ParamSpec((d_model, d_ff), ("embed", "mlp"),
                        stddev=d_model ** -0.5),
        "w2": ParamSpec((d_ff, d_model), ("mlp", "embed"),
                        stddev=d_ff ** -0.5),
    }
    if glu:
        specs["w3"] = ParamSpec((d_model, d_ff), ("embed", "mlp"),
                                stddev=d_model ** -0.5)
    return specs


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name.startswith("silu"):
        return F.silu(x)
    if name.startswith("gelu"):
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(x, approximate="tanh")
    if name == "relu2":  # nemotron-4 squared ReLU
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {name!r}")


def mlp(params: Params, x: torch.Tensor, act: str, dtype: torch.dtype) -> torch.Tensor:
    h = _act(act, x @ params["w1"].to(dtype))
    if act.endswith("_glu"):
        h = h * (x @ params["w3"].to(dtype))
    return h @ params["w2"].to(dtype)


# ---------------------------------------------------------------------------
# Embedding + LM head
# ---------------------------------------------------------------------------

def embed_specs(cfg: ModelConfig) -> dict:
    # N(0, 1/d): the sqrt(d) input scaling then yields unit-variance hidden
    # states, and tied-embedding logits stay O(1) at init.
    return {"tok": ParamSpec((cfg.padded_vocab, cfg.d_model),
                             ("vocab", "embed"),
                             stddev=cfg.d_model ** -0.5)}


def embed(params: Params, tokens: torch.Tensor, dtype: torch.dtype,
          d_model: int) -> torch.Tensor:
    w = params["tok"].to(dtype)
    h = w[tokens.long()]
    # sqrt(d_model) in the compute dtype, as the reference: 31.0 in bf16
    return h * torch.tensor(d_model, dtype=dtype) ** 0.5


def lm_head_specs(cfg: ModelConfig) -> dict:
    if cfg.tie_embeddings:
        return {}
    return {"w": ParamSpec((cfg.d_model, cfg.padded_vocab),
                           ("embed", "vocab"), stddev=cfg.d_model ** -0.5)}


def lm_head(params: Params, embed_params: Params, h: torch.Tensor,
            tie: bool, dtype: torch.dtype) -> torch.Tensor:
    """Logits over the padded vocabulary, in the compute dtype."""
    if tie:
        w = embed_params["tok"].to(dtype).t()
    else:
        w = params["w"].to(dtype)
    return h @ w


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device: torch.device | str = "cpu"
               ) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (hd/2,)
    angles = positions[..., None].float() * freqs               # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                       # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Loss: chunked softmax cross-entropy (+ z-loss), stable in fp32
# ---------------------------------------------------------------------------

def softmax_xent_chunked(logits_fn, h: torch.Tensor, labels: torch.Tensor,
                         weights: torch.Tensor, *, chunk: int = 1024,
                         z_loss: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross entropy without materializing (B, S, V) fp32 logits at once.

    ``logits_fn(h_chunk) -> (B, c, V)`` maps hidden states to logits (bf16
    ok); the reduction is computed per sequence chunk in fp32, the ragged
    remainder last, as the reference does. The logsumexp runs over every
    column ``logits_fn`` returns, padded vocabulary included, as the
    reference's does. Returns (sum_loss, sum_weight)."""
    B, S, _ = h.shape
    chunk = min(chunk, S)
    n = S // chunk

    def one(lo, hi):
        logits = logits_fn(h[:, lo:hi]).float()                    # (B, c, V)
        lse = torch.logsumexp(logits, dim=-1)                      # (B, c)
        ll = torch.gather(logits, -1, labels[:, lo:hi, None].long())[..., 0]
        nll = lse - ll
        if z_loss:
            nll = nll + z_loss * torch.square(lse)
        w = weights[:, lo:hi]
        return torch.sum(nll * w), torch.sum(w)

    loss = wsum = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n):
        l, w = one(i * chunk, (i + 1) * chunk)
        loss, wsum = loss + l, wsum + w
    if S > n * chunk:
        l, w = one(n * chunk, S)
        loss, wsum = loss + l, wsum + w
    return loss, wsum
