"""AdamW with fp32 master state, global-norm clipping and the LR schedule,
over trees of tensors (nested dicts, lists and tuples, as ``Model.params_tree``
gives them).

The port of ``repro.train.optimizer``, with the same arithmetic in the same
order, so one step moves parameters, m and v as the JAX package does:
``sqrt(v / bc2)`` (``torch.optim.AdamW`` takes ``sqrt(v) / sqrt(bc2)``) and
the decay inside the update, ``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd *
p)``. Scalars (step, learning rate, bias corrections, clip scale) are fp32
tensors on the parameters' device, as in the reference, so a step makes no
host round trip.

Unlike the reference, :func:`adamw_update` updates parameters, m and v in
place and returns the same tensors: the optimizer state of a 360M-parameter
model is 2.9 GB, and a copy per step would double it. Callers that keep a
state for later (a rollback, a replay) clone it first.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.config import TrainConfig

Params = Any


def tree_leaves(tree: Any) -> list:
    """The leaves in the JAX package's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like: Any, leaves: list) -> Any:
    """A tree shaped like ``like`` with ``leaves`` in :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}          # keep the caller's key order
        if isinstance(t, (list, tuple)):
            out = [build(v) for v in t]
            return type(t)(*out) if hasattr(t, "_fields") else type(t)(out)
        return next(it)
    return build(like)


def tree_map(fn, *trees: Any) -> Any:
    return tree_unflatten(trees[0], [fn(*xs) for xs in
                                     zip(*(tree_leaves(t) for t in trees))])


class AdamState(NamedTuple):
    m: Params
    v: Params
    step: torch.Tensor        # int32, 0-dim


def adamw_init(params: Params) -> AdamState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
    return AdamState(m=zeros, v=tree_map(torch.clone, zeros), step=step)


def global_norm(tree: Params) -> torch.Tensor:
    leaves = tree_leaves(tree)
    total = torch.square(leaves[0].float()).sum()
    for leaf in leaves[1:]:
        total = total + torch.square(leaf.float()).sum()
    return torch.sqrt(total)


def clip_by_global_norm(grads: Params, max_norm: float):
    """(grads * min(1, max_norm / max(norm, 1e-9)), norm); new fp32 tensors
    (the reference's fp32 scale promotes bf16 gradients to fp32)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


def lr_schedule(cfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to 10% of peak (fp32, as the
    reference computes it)."""
    step = step.to(torch.float32)
    warm = cfg.learning_rate * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.learning_rate * (0.1 + 0.45 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


@torch.no_grad()
def adamw_update(grads: Params, state: AdamState, params: Params,
                 cfg: TrainConfig) -> tuple[Params, AdamState, dict]:
    """One AdamW step, in place (see the module docstring): returns
    ``(params, state, {"grad_norm", "lr"})`` holding the updated tensors."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2, eps = cfg.adam_b1, cfg.adam_b2, cfg.adam_eps
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=step.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=step.device), stepf)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        g = g.float()
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) + cfg.weight_decay * p
        p.copy_(p - lr * delta)
    state.step.copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# int8 error-feedback gradient compression (optional distributed-opt trick)
# ---------------------------------------------------------------------------

class CompressorState(NamedTuple):
    error: Params     # residual feedback buffers (fp32)


def compressor_init(params: Params) -> CompressorState:
    return CompressorState(error=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params))


def compress_decompress(g: torch.Tensor, err: torch.Tensor):
    """Quantize (g + err) to int8 with a per-tensor scale; returns the
    dequantized value and the new error. The int8 payload is what would
    cross the wire; error feedback keeps the optimizer unbiased over time."""
    x = g.float() + err
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, x - deq


def compress_grads(grads: Params, state: CompressorState):
    out = [compress_decompress(g, e) for g, e in
           zip(tree_leaves(grads), tree_leaves(state.error))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            CompressorState(error=tree_unflatten(grads, [o[1] for o in out])))
