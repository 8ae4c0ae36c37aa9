"""Mamba2 block via SSD (state-space duality, arXiv:2405.21060).

The functions of ``repro.models.mamba`` with the same numerics: the
projections and the causal conv in the compute dtype, ``dt`` and ``A`` in
fp32, the chunked scan through :func:`repro_torch.kernels.ssd.ssd` (the CUDA
kernel on the card, its plain version on the CPU) and decode as the O(1)
state recurrence in plain PyTorch. Projections are separate matrices
(z/x/B/C/dt), as in the reference, so parameters move leaf for leaf.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.config import SSMConfig
from repro_torch.kernels.ssd import ssd as ssd_kernel
from repro_torch.models.layers import rmsnorm
from repro_torch.models.spec import ParamSpec

Params = Any


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def mamba_specs(cfg: SSMConfig, d_model: int) -> dict:
    d_in = cfg.d_inner(d_model)
    H = cfg.num_ssm_heads(d_model)
    GN = cfg.n_groups * cfg.state_dim
    s = d_model ** -0.5
    w = cfg.conv_width
    return {
        "in_z": ParamSpec((d_model, d_in), ("embed", "ssm_inner"), stddev=s),
        "in_x": ParamSpec((d_model, d_in), ("embed", "ssm_inner"), stddev=s),
        "in_B": ParamSpec((d_model, GN), ("embed", None), stddev=s),
        "in_C": ParamSpec((d_model, GN), ("embed", None), stddev=s),
        "in_dt": ParamSpec((d_model, H), ("embed", "ssm_heads"), stddev=s),
        "conv_x": ParamSpec((w, d_in), (None, "ssm_inner"), stddev=w ** -0.5),
        "conv_x_b": ParamSpec((d_in,), ("ssm_inner",), init="zeros"),
        "conv_B": ParamSpec((w, GN), (None, None), stddev=w ** -0.5),
        "conv_B_b": ParamSpec((GN,), (None,), init="zeros"),
        "conv_C": ParamSpec((w, GN), (None, None), stddev=w ** -0.5),
        "conv_C_b": ParamSpec((GN,), (None,), init="zeros"),
        "A_log": ParamSpec((H,), ("ssm_heads",), init="a_log"),
        "dt_bias": ParamSpec((H,), ("ssm_heads",), init="zeros"),
        "D": ParamSpec((H,), ("ssm_heads",), init="ones"),
        "norm": ParamSpec((d_in,), ("ssm_inner",), init="ones"),
        "out": ParamSpec((d_in, d_model), ("ssm_inner", "embed"),
                         stddev=d_in ** -0.5),
    }


# ---------------------------------------------------------------------------
# causal depthwise conv (width 4: unrolled shifts)
# ---------------------------------------------------------------------------

def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (B, L, C); w: (W, C) -> (B, L, C), causal. The shifted terms are
    added in the reference's order, in x's dtype, so bf16 rounds where the
    reference rounds."""
    W, L = w.shape[0], x.shape[1]
    out = x * w[-1]
    for i in range(1, W):
        shifted = F.pad(x, (0, 0, i, 0))[:, :L]
        out = out + shifted * w[-1 - i]
    return out + b


def causal_conv_step(x_t: torch.Tensor, state: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token conv. x_t: (B, C); state: (B, W-1, C) holds prior inputs.
    Returns (out (B, C), the next state). The W products are summed in fp32
    and rounded once, as the reference's einsum does."""
    full = torch.cat([state, x_t[:, None, :]], dim=1)            # (B, W, C)
    out = (full.float() * w.float()).sum(dim=1).to(x_t.dtype) + b
    return out, full[:, 1:]


# ---------------------------------------------------------------------------
# decode: the O(1) state recurrence
# ---------------------------------------------------------------------------

def ssd_decode_step(state: torch.Tensor, x_t: torch.Tensor, dt_t: torch.Tensor,
                    A: torch.Tensor, B_t: torch.Tensor, C_t: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token SSD. state: (b, H, P, N); x_t: (b, H, P); dt_t: (b, H);
    B_t, C_t: (b, G, N). Returns (y_t (b, H, P) in x_t's dtype, the new
    fp32 state)."""
    H = state.shape[1]
    rep = H // B_t.shape[1]
    f32 = torch.float32
    Bh = torch.repeat_interleave(B_t, rep, dim=1).to(f32)        # (b, H, N)
    Ch = torch.repeat_interleave(C_t, rep, dim=1).to(f32)
    decay = torch.exp(dt_t.to(f32) * A.to(f32))                   # (b, H)
    upd = (dt_t.to(f32)[..., None, None] * x_t.to(f32)[..., None]
           * Bh[:, :, None, :])                                   # (b, H, P, N)
    new_state = decay[..., None, None] * state.to(f32) + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y.to(x_t.dtype), new_state


# ---------------------------------------------------------------------------
# full mamba2 block
# ---------------------------------------------------------------------------

def _project(params: Params, x: torch.Tensor, dtype) -> tuple:
    return tuple(x @ params[n].to(dtype)
                 for n in ("in_z", "in_x", "in_B", "in_C", "in_dt"))


def _dt_and_A(params: Params, dt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """softplus(dt + dt_bias) and A = -exp(A_log), both fp32;
    ``logaddexp(v, 0)`` is ``jax.nn.softplus``."""
    v = dt.float() + params["dt_bias"].float()
    A = -torch.exp(params["A_log"].float())
    return torch.logaddexp(v, torch.zeros_like(v)), A


def _gate_out(params: Params, y: torch.Tensor, z: torch.Tensor, norm_eps: float,
              dtype) -> torch.Tensor:
    """Gated RMSNorm over d_inner (fp32 ``norm`` scale: the RMSNorm kernel on
    the card), then the output projection."""
    y = rmsnorm({"scale": params["norm"]}, y * F.silu(z), norm_eps)
    return y @ params["out"].to(dtype)


def mamba_forward(params: Params, cfg: SSMConfig, x: torch.Tensor, *,
                  d_model: int, dtype, norm_eps: float = 1e-5,
                  return_state: bool = False):
    """Full-sequence mamba2 block. x: (B, L, d_model). With ``return_state``
    returns (y, cache) where the cache holds the final SSM state and the
    last W-1 pre-conv inputs of each conv, as ``mamba_cache_init`` lays
    them out."""
    b, L, _ = x.shape
    H = cfg.num_ssm_heads(d_model)
    P = cfg.head_dim
    G, N = cfg.n_groups, cfg.state_dim
    z, xi_raw, Bi_raw, Ci_raw, dt = _project(params, x, dtype)
    xi = F.silu(causal_conv(xi_raw, params["conv_x"].to(dtype),
                            params["conv_x_b"].to(dtype)))
    Bi = F.silu(causal_conv(Bi_raw, params["conv_B"].to(dtype),
                            params["conv_B_b"].to(dtype)))
    Ci = F.silu(causal_conv(Ci_raw, params["conv_C"].to(dtype),
                            params["conv_C_b"].to(dtype)))
    xh = xi.reshape(b, L, H, P)
    dt_sp, A = _dt_and_A(params, dt)
    y, final_state = ssd_kernel(xh, dt_sp, A, Bi.reshape(b, L, G, N),
                                Ci.reshape(b, L, G, N), chunk=cfg.chunk_size)
    y = y + params["D"].to(y.dtype)[None, None, :, None] * xh
    y = _gate_out(params, y.reshape(b, L, H * P), z, norm_eps, dtype)
    if not return_state:
        return y
    # conv tails: the last W-1 pre-conv inputs. The reference projects x a
    # second time for them; the first projection's outputs are the same
    # numbers.
    W = cfg.conv_width

    def tail(v):
        return F.pad(v, (0, 0, max(W - 1 - L, 0), 0))[:, -(W - 1):]
    return y, {"ssm": final_state, "conv_x": tail(xi_raw),
               "conv_B": tail(Bi_raw), "conv_C": tail(Ci_raw)}


def mamba_cache_init(cfg: SSMConfig, batch: int, d_model: int, dtype,
                     device: torch.device | str = "cpu") -> dict:
    H = cfg.num_ssm_heads(d_model)
    d_in = cfg.d_inner(d_model)
    GN = cfg.n_groups * cfg.state_dim
    W = cfg.conv_width
    return {
        "ssm": torch.zeros((batch, H, cfg.head_dim, cfg.state_dim),
                           dtype=torch.float32, device=device),
        "conv_x": torch.zeros((batch, W - 1, d_in), dtype=dtype, device=device),
        "conv_B": torch.zeros((batch, W - 1, GN), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, W - 1, GN), dtype=dtype, device=device),
    }


def mamba_decode(params: Params, cfg: SSMConfig, x: torch.Tensor, cache: dict, *,
                 d_model: int, dtype, norm_eps: float = 1e-5
                 ) -> tuple[torch.Tensor, dict]:
    """One-token decode. x: (B, 1, d_model).

    Writes the new SSM state and conv tails into ``cache`` in place (as
    ``gqa_decode`` writes its KV slot) and returns (y, cache)."""
    b = x.shape[0]
    H = cfg.num_ssm_heads(d_model)
    P = cfg.head_dim
    G, N = cfg.n_groups, cfg.state_dim
    z, xi, Bi, Ci, dt = _project(params, x[:, 0], dtype)
    conv = {}
    outs = []
    for name, v in (("conv_x", xi), ("conv_B", Bi), ("conv_C", Ci)):
        o, conv[name] = causal_conv_step(v, cache[name], params[name].to(dtype),
                                         params[name + "_b"].to(dtype))
        outs.append(F.silu(o))
    xi, Bi, Ci = outs
    dt_sp, A = _dt_and_A(params, dt)
    y, new_state = ssd_decode_step(cache["ssm"], xi.reshape(b, H, P), dt_sp, A,
                                   Bi.reshape(b, G, N), Ci.reshape(b, G, N))
    y = y + params["D"].to(y.dtype)[None, :, None] * xi.reshape(b, H, P)
    y = _gate_out(params, y.reshape(b, 1, H * P), z[:, None, :], norm_eps, dtype)
    cache["ssm"].copy_(new_state)
    for name, t in conv.items():
        cache[name].copy_(t)
    return y, cache
