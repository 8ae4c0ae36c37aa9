"""Loss-spike detection and rollback policy (paper §5.3 / §6.1).

Paper: "A 'loss spike' refers to a sudden increase in the loss that was
previously decreasing normally, and does not recover over a certain period.
... if the failure is attributed to a sudden increase in loss, we opt to an
earlier healthy restart checkpoint and bypass subsequent data batches."

Detector: rolling median + MAD (robust to the heavy-tailed LM loss curve).
A step is *spiking* when loss > median + z_threshold * (1.4826 * MAD).
A spike *event* fires only after ``patience`` consecutive spiking steps
(transient single-step spikes recover on their own and are ignored, matching
the paper's "does not recover over a certain period").

The policy names the rollback checkpoint (the newest checkpoint at or before
the spike onset minus ``margin`` steps — "an *earlier healthy* checkpoint",
not merely the latest, which may already be poisoned) and the data range to
skip (onset .. detection, padded by ``skip_margin``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class SpikeEvent:
    onset_step: int           # first spiking step
    detect_step: int          # step at which patience ran out
    rollback_step: int        # checkpoint step to resume from
    skip_range: tuple[int, int]   # data steps [lo, hi) to bypass
    baseline: float
    peak: float


class SpikeDetector:
    def __init__(self, *, window: int = 64, z_threshold: float = 6.0,
                 patience: int = 4, min_history: int = 16,
                 skip_margin: int = 8, ckpt_margin: int = 0):
        self.window = window
        self.z_threshold = z_threshold
        self.patience = patience
        self.min_history = min_history
        self.skip_margin = skip_margin
        self.ckpt_margin = ckpt_margin
        self._hist: list[tuple[int, float]] = []   # healthy (step, loss)
        self._spiking: list[tuple[int, float]] = []  # consecutive spike steps

    def _threshold(self) -> Optional[float]:
        if len(self._hist) < self.min_history:
            return None
        vals = np.array([l for _, l in self._hist[-self.window:]])
        med = float(np.median(vals))
        mad = float(np.median(np.abs(vals - med)))
        sigma = 1.4826 * mad if mad > 0 else max(1e-3, 0.05 * abs(med))
        return med + self.z_threshold * sigma

    def update(self, step: int, loss: float,
               available_ckpts: Sequence[int] = ()) -> Optional[SpikeEvent]:
        """Feed one (step, loss); returns a SpikeEvent when one is confirmed."""
        if not np.isfinite(loss):
            loss = float("inf")
        thr = self._threshold()
        if thr is not None and loss > thr:
            self._spiking.append((step, loss))
            if len(self._spiking) >= self.patience:
                onset = self._spiking[0][0]
                peak = max(l for _, l in self._spiking)
                target = onset - self.ckpt_margin
                older = [c for c in available_ckpts if c <= target]
                rollback = max(older) if older else (
                    min(available_ckpts) if available_ckpts else 0)
                event = SpikeEvent(
                    onset_step=onset, detect_step=step,
                    rollback_step=rollback,
                    skip_range=(max(rollback, onset - self.skip_margin),
                                step + self.skip_margin),
                    baseline=float(np.median(
                        [l for _, l in self._hist[-self.window:]])),
                    peak=peak)
                self._spiking.clear()
                return event
        else:
            self._spiking.clear()
            self._hist.append((step, loss))
            if len(self._hist) > 4 * self.window:
                del self._hist[: 2 * self.window]
        return None

    def reset_after_rollback(self, resume_step: int) -> None:
        """Drop history newer than the rollback point."""
        self._hist = [(s, l) for s, l in self._hist if s <= resume_step]
        self._spiking.clear()
