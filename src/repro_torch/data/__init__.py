"""Deterministic, resumable data pipeline: the port's own copy of
``repro.data`` (numpy only), so that both packages give the same batches bit
for bit at every step.

Every batch is a pure function of (seed, step); resuming a job at step N —
or *skipping* a bad range of batches after a loss-spike rollback (paper
§6.1: "opt to an earlier healthy checkpoint and bypass subsequent data
batches") — needs no iterator state beyond the step counter and a skip set.

The synthetic corpus is a Zipf-distributed token stream with injected
structure (periodic motifs) so small models can actually learn (loss drops),
giving the end-to-end example a real training signal.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 8
    motif_prob: float = 0.5


class SyntheticLM:
    """Deterministic synthetic LM dataset: batch(step) is pure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # token unigram distribution (Zipf over the real vocab)
        ranks = np.arange(1, cfg.vocab_size + 1)
        p = ranks ** (-cfg.zipf_a)
        self._p = p / p.sum()
        # a bank of motifs the model can learn to predict
        self._motifs = rng.integers(
            0, cfg.vocab_size, size=(64, cfg.motif_len)).astype(np.int32)

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S = cfg.global_batch, cfg.seq_len
        toks = rng.choice(cfg.vocab_size, size=(B, S + 1),
                          p=self._p).astype(np.int32)
        # paste motifs at random offsets: learnable structure
        n_paste = int(cfg.motif_prob * B * S / cfg.motif_len)
        if n_paste:
            rows = rng.integers(0, B, n_paste)
            cols = rng.integers(0, S + 1 - cfg.motif_len, n_paste)
            ids = rng.integers(0, len(self._motifs), n_paste)
            for r, c, i in zip(rows, cols, ids):
                toks[r, c:c + cfg.motif_len] = self._motifs[i]
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "weights": np.ones((B, S), np.float32),
        }


class DataLoader:
    """Stateful wrapper: step counter + skip set (for spike rollbacks).

    State is two integers and a list — trivially checkpointable.
    """

    def __init__(self, dataset: SyntheticLM, start_step: int = 0,
                 skip_ranges: Optional[list[tuple[int, int]]] = None):
        self.dataset = dataset
        self.step = start_step
        self.skip_ranges = list(skip_ranges or [])

    def _skipped(self, step: int) -> bool:
        return any(lo <= step < hi for lo, hi in self.skip_ranges)

    def next(self) -> tuple[int, dict]:
        while self._skipped(self.step):
            self.step += 1
        step = self.step
        self.step += 1
        return step, self.dataset.batch(step)

    def skip(self, lo: int, hi: int) -> None:
        """Mark data steps [lo, hi) as poisoned (loss-spike mitigation)."""
        self.skip_ranges.append((lo, hi))

    def state_dict(self) -> dict:
        return {"step": self.step, "skip_ranges": self.skip_ranges}

    def load_state_dict(self, d: dict) -> None:
        self.step = int(d["step"])
        self.skip_ranges = [tuple(x) for x in d["skip_ranges"]]
