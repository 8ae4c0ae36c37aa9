"""Serving: the decode step and batched greedy generation."""
from __future__ import annotations

import torch

from repro_torch.models import Model


def make_serve_step(model: Model):
    """decode_step(caches, tokens, cur_index) -> (logits, caches)."""
    def step(caches, tokens, cur_index):
        return model.decode_step(caches, tokens, cur_index)
    return step


def greedy_generate(model: Model, prompt: torch.Tensor,
                    n_tokens: int) -> torch.Tensor:
    """Batched greedy decode of ``n_tokens`` per prompt row: (B, n_tokens)."""
    B, S = prompt.shape
    logits, caches = model.prefill({"tokens": prompt})
    step_fn = make_serve_step(model)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [tok]
    for t in range(S, S + n_tokens - 1):
        logits, caches = step_fn(caches, tok, t)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, dim=1)
