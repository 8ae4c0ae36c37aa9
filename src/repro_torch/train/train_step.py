"""The train step: loss -> grads -> (clip) -> AdamW, with microbatch gradient
accumulation. The port of ``repro.train.train_step.make_train_step``.

Gradients: with ``parallel.grad_dtype == "float32"`` autograd differentiates
the fp32 master parameters (each layer casts them where it uses them); with
``"bfloat16"`` it differentiates a bf16 cast of them, as the reference
differentiates ``cast_floating(params, bf16)``, and AdamW applies the bf16
gradients to the fp32 masters. Microbatch gradients are summed in fp32, in
order, then divided by their count; metrics are the mean over microbatches,
plus ``grad_norm`` and ``lr``.

The step updates parameters, m and v in place (see
:mod:`repro_torch.train.optimizer`) and then tells the model its parameters
changed (``Model.params_changed``), so that serving after a step sees them.
The reference's sharding helpers (``opt_rules``, ``state_shardings``,
``batch_shardings``, ``compile_train_step``, ``abstract_batch``) wait for
the port's device mesh (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.config import TrainConfig
from repro_torch.train.optimizer import (AdamState, adamw_update, tree_leaves,
                                         tree_unflatten)

Params = Any


def make_train_step(model, tcfg: TrainConfig) -> Callable:
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``. ``params`` is a tree shaped like ``model.specs()`` (usually
    ``model.params_tree()``, the model's own tensors); ``batch`` holds
    ``tokens``, ``labels`` (int, (B, S)) and optionally ``weights`` (fp32)
    on the model's device, B divisible by ``tcfg.microbatches``. Metrics are
    0-dim fp32 tensors on the device: reading them synchronizes."""
    bf16_grads = model.parallel.grad_dtype == "bfloat16"

    def grads_of(params: Params, mb: dict):
        leaves = tree_leaves(params)
        with torch.no_grad():
            diff = [(p.to(torch.bfloat16) if bf16_grads and p.is_floating_point()
                     else p.detach()).requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss, metrics = model.loss(tree_unflatten(params, diff), mb)
            grads = torch.autograd.grad(loss, diff)
        return ({k: v.detach() for k, v in metrics.items()}, grads)

    def step(params: Params, opt_state: AdamState, batch: dict):
        k = tcfg.microbatches
        n = batch["tokens"].shape[0]
        if n % k:
            raise ValueError(f"batch of {n} not divisible into {k} microbatches")
        acc = None
        metrics_all = []
        for i in range(k):
            mb = {name: x[i * n // k:(i + 1) * n // k] for name, x in batch.items()}
            metrics, grads = grads_of(params, mb)
            metrics_all.append(metrics)
            if acc is None:
                acc = [g.float() for g in grads]      # no copy for fp32 gradients
            else:
                for a, g in zip(acc, grads):
                    a.add_(g)
            del grads
        if k > 1:
            for a in acc:
                a.div_(k)
        metrics = {name: torch.stack([m[name] for m in metrics_all]).mean()
                   for name in metrics_all[0]}
        params, opt_state, opt_metrics = adamw_update(
            tree_unflatten(params, acc), opt_state, params, tcfg)
        model.params_changed()
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return step
