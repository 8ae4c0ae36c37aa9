"""Mixture-of-Experts FFN: the router, the load-balancing loss, and the
reference's two unsharded execution paths.

The JAX package (``repro.models.moe``) has three paths. This module ports
the two that run without a device mesh, with the same choice between them:

* ``dense`` evaluates every expert on every token and combines the outputs
  with the renormalized top-k gates. Exact (no capacity drops). Prefill,
  training and (by default) decode run it.
* ``gather`` (decode only, when ``parallel.decode_moe_impl == "gather"`` and
  B * S * top_k < num_experts) gathers the top-k experts' weights per token,
  so a step reads k experts' weights per token instead of all of them.

``gshard`` (expert parallelism with all-to-all) and ``tp`` (expert-tensor
parallelism with a psum), and the capacity dispatch helpers only they use,
need a mesh: they wait for ROADMAP Queue 1 item 12, which adds the
reference's ``rules`` argument with them. The expert products are plain
PyTorch matrix products (cuBLAS on the card), as the reference leaves them
to XLA.

The load-balancing loss is computed only where it is read (``with_aux``):
the reference drops it under ``jit`` when serving, and here serving skips
its launches.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import torch

from repro_torch.config import ModelConfig, MoEConfig, ParallelConfig
from repro_torch.models.layers import _act, mlp, mlp_specs
from repro_torch.models.spec import ParamSpec

Params = Any


def moe_specs(d_model: int, cfg: MoEConfig, act: str) -> dict:
    E, eff = cfg.num_experts, cfg.expert_ff
    glu = act.endswith("_glu")
    s_in, s_out = d_model ** -0.5, eff ** -0.5
    specs = {
        "router": ParamSpec((d_model, E), ("embed", None), stddev=s_in),
        "w1": ParamSpec((E, d_model, eff), ("experts", "embed", "expert_mlp"),
                        stddev=s_in),
        "w2": ParamSpec((E, eff, d_model), ("experts", "expert_mlp", "embed"),
                        stddev=s_out),
    }
    if glu:
        specs["w3"] = ParamSpec((E, d_model, eff),
                                ("experts", "embed", "expert_mlp"), stddev=s_in)
    if cfg.num_shared_experts:
        specs["shared"] = mlp_specs(d_model, cfg.num_shared_experts * eff, act)
    return specs


def _route(router_w: torch.Tensor, x: torch.Tensor, cfg: MoEConfig):
    """x: (T, d) -> (gates (T, k) fp32, expert_idx (T, k), probs (T, E) fp32):
    softmax in fp32 over the router logits, top-k, the k gates renormalized."""
    logits = (x @ router_w.to(x.dtype)).float()                   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)              # (T, k)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return gates, idx, probs


def _aux_loss(probs: torch.Tensor, idx: torch.Tensor, E: int) -> torch.Tensor:
    """Switch-style load-balancing loss: E * sum_e f_e * P_e."""
    assign = torch.nn.functional.one_hot(idx, E).float().sum(dim=1)   # (T, E)
    f = assign.mean(dim=0)
    p = probs.mean(dim=0)
    return E * torch.sum(f * p)


def moe_dense(params: Params, cfg: MoEConfig, x: torch.Tensor, *, act: str,
              dtype, with_aux: bool = True) -> tuple[torch.Tensor, Union[torch.Tensor, float]]:
    """Every expert on every token, combined with the routing weights.

    The reference materializes each expert's output (T, E, d) and sums it
    with the weights; here the weights scale each expert's hidden
    activations first, and one product over (expert, hidden) does the sum:
    the same function, without the (T, E, d) tensor (1 GB at deepseek-v2's
    4 x 1024-token prefill). aux is 0.0 unless ``with_aux``."""
    B, S, d = x.shape
    E = cfg.num_experts
    T = B * S
    xt = x.reshape(T, d)
    gates, idx, probs = _route(params["router"], xt, cfg)
    aux = _aux_loss(probs, idx, E) if with_aux else 0.0
    w = torch.zeros((T, E), dtype=torch.float32, device=x.device).scatter(1, idx, gates)
    w1 = params["w1"].to(dtype)
    h = _act(act, torch.matmul(xt, w1))                           # (E, T, f)
    if "w3" in params:
        h = h * torch.matmul(xt, params["w3"].to(dtype))
    h = h * w.t().to(dtype)[:, :, None]
    f = h.shape[-1]
    y = h.transpose(0, 1).reshape(T, E * f) @ params["w2"].to(dtype).reshape(E * f, d)
    return y.reshape(B, S, d), aux


def moe_gather_decode(params: Params, cfg: MoEConfig, x: torch.Tensor, *, act: str,
                      dtype, with_aux: bool = True
                      ) -> tuple[torch.Tensor, Union[torch.Tensor, float]]:
    """Small-batch decode: gather only the top-k experts' weights per token.

    Beats dense-all when B*S*k << E (e.g. batch-1 long-context decode):
    weight reads drop from all E experts to k per token. aux is 0.0 unless
    ``with_aux``."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    gates, idx, probs = _route(params["router"], xt, cfg)
    aux = _aux_loss(probs, idx, cfg.num_experts) if with_aux else 0.0
    w1 = params["w1"][idx].to(dtype)                              # (T, k, d, f)
    h = _act(act, torch.einsum("td,tkdf->tkf", xt, w1))
    if "w3" in params:
        h = h * torch.einsum("td,tkdf->tkf", xt, params["w3"][idx].to(dtype))
    out = torch.einsum("tkf,tkfd->tkd", h, params["w2"][idx].to(dtype))
    y = torch.einsum("tkd,tk->td", out, gates.to(dtype))
    return y.reshape(B, S, d), aux


def moe_forward(params: Params, model_cfg: ModelConfig, x: torch.Tensor, *,
                parallel: Optional[ParallelConfig], decode: bool, dtype,
                with_aux: bool = True) -> tuple[torch.Tensor, Union[torch.Tensor, float]]:
    """The MoE FFN with the reference's unsharded choice of path and its
    shared experts; returns (y, aux * router_aux_coef), aux 0.0 unless
    ``with_aux``."""
    cfg = model_cfg.moe
    act = model_cfg.mlp_act
    impl = "dense"
    if decode and parallel is not None:
        B, S, _ = x.shape
        if parallel.decode_moe_impl == "gather" and B * S * cfg.top_k < cfg.num_experts:
            impl = "gather"
    if impl == "gather":
        y, aux = moe_gather_decode(params, cfg, x, act=act, dtype=dtype,
                                   with_aux=with_aux)
    else:
        y, aux = moe_dense(params, cfg, x, act=act, dtype=dtype, with_aux=with_aux)
    if cfg.num_shared_experts:
        y = y + mlp(params["shared"], x, act, dtype)
    return y, aux * cfg.router_aux_coef
