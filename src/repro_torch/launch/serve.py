"""Batched serving: prefill + greedy decode through each layer's cache
(the ring-buffer KV cache of attention layers, the SSM state and conv
tails of mamba layers), on the card unless the caller asks for the CPU.

The importable surface is :class:`ServeSession` — build the model and its
parameters once, then drive :meth:`~ServeSession.prefill` /
:meth:`~ServeSession.decode_step` (or :meth:`~ServeSession.generate`) as many
times as needed; each call returns a :class:`ServeTimings`. There is no
device mesh: one session runs on one device.

CLI (thin argparse wrapper over ServeSession):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      [--smoke] [--device cpu] --batch 4 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \
      [--smoke] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.config import get_arch, get_smoke
from repro_torch.models import Model
from repro_torch.models.spec import init_params
from repro_torch.serve import make_serve_step
from repro_torch.utils import logger, resolve_device


@dataclasses.dataclass(frozen=True, slots=True)
class ServeTimings:
    """Wall-clock accounting for one serving phase.

    ``tokens`` is the number of tokens the phase handled (batch * prompt for
    prefill, batch * steps for decode). On the card the clock stops after
    ``torch.cuda.synchronize()``."""
    phase: str
    seconds: float
    batch: int
    tokens: int

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / max(self.seconds, 1e-9)


class ServeSession:
    """One resident serving instance: model and parameters built once.

    ``prefill(batch)`` runs the prompt pass and keeps the caches and the
    first greedy token as session state; ``decode_step()`` appends one
    greedy token per sequence. ``generate(prompt, n)`` chains the two.
    ``dtype`` overrides the config's compute dtype (e.g. ``"float32"``).
    """

    def __init__(self, arch: str = "smollm-360m", *, smoke: bool = False,
                 seed: int = 0, device=None, dtype: Optional[str] = None) -> None:
        self.device = resolve_device(device)
        cfg = get_smoke(arch) if smoke else get_arch(arch)
        if dtype is not None:
            cfg = dataclasses.replace(cfg, dtype=dtype)
        self.cfg = cfg
        self._seed = seed
        self.model = Model(cfg, device=self.device, seed=seed)
        self._step_fn = make_serve_step(self.model)
        self._caches = None
        self._tok = None
        self._pos = 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def make_batch(self, batch: int, prompt_len: int, seed: int = 0) -> dict:
        """Random token batch, drawn exactly as the JAX package draws it."""
        rng = np.random.default_rng(seed)
        prompt = rng.integers(0, self.cfg.vocab_size, (batch, prompt_len),
                              dtype=np.int32)
        return {"tokens": torch.from_numpy(prompt).to(self.device)}

    def prefill(self, batch: dict) -> ServeTimings:
        """Prompt pass; stores caches + first greedy token on the session."""
        tokens = batch["tokens"]
        self._sync()
        t0 = time.perf_counter()
        logits, caches = self.model.prefill(batch)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        self._sync()
        dt = time.perf_counter() - t0
        self._caches, self._tok = caches, tok
        self._pos = int(tokens.shape[1])
        return ServeTimings("prefill", dt, int(tokens.shape[0]),
                            int(tokens.shape[0] * tokens.shape[1]))

    def decode_step(self, n_steps: int = 1) -> tuple[torch.Tensor, ServeTimings]:
        """Greedy-decode ``n_steps`` tokens per sequence.

        Returns the generated tokens ``[batch, n_steps]`` and the phase
        timings. The session always holds one generated-but-unreturned
        token (prefill's argmax at first), so consecutive calls emit a
        contiguous, non-overlapping token stream."""
        if self._caches is None:
            raise RuntimeError("decode_step before prefill")
        tok = self._tok
        out = []
        self._sync()
        t0 = time.perf_counter()
        for t in range(self._pos, self._pos + n_steps):
            out.append(tok)
            logits, self._caches = self._step_fn(self._caches, tok, t)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        self._sync()
        dt = time.perf_counter() - t0
        self._pos += n_steps
        self._tok = tok
        return torch.stack(out, dim=1), ServeTimings(
            "decode", dt, int(tok.shape[0]), int(tok.shape[0] * n_steps))

    def generate(self, batch: dict, n_tokens: int
                 ) -> tuple[torch.Tensor, ServeTimings, ServeTimings]:
        """Prefill then greedy-decode ``n_tokens``; returns
        (tokens ``[batch, n_tokens]``, prefill timings, decode timings)."""
        tp = self.prefill(batch)
        gen, td = self.decode_step(n_tokens)
        return gen, tp, td

    def restart(self) -> ServeTimings:
        """In-place restart: drop the caches, the pending greedy token and
        the position cursor, and re-initialize the parameters from the
        session seed; resident requests re-enter through :meth:`prefill`."""
        self._caches = None
        self._tok = None
        self._pos = 0
        self._sync()
        t0 = time.perf_counter()
        self.model.load_params(init_params(self.model.specs(), self._seed,
                                           self.device))
        self._sync()
        return ServeTimings("restart", time.perf_counter() - t0, 0, 0)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; the card (cuda) when omitted")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--restarts", type=int, default=0,
                    help="in-place restarts between generations")
    args = ap.parse_args()

    sess = ServeSession(args.arch, smoke=args.smoke, device=args.device)
    for i in range(args.restarts + 1):
        gen, tp, td = sess.generate(
            sess.make_batch(args.batch, args.prompt_len), args.gen)
        logger.info("prefill %.3fs (%.1f tok/s); decode %d x %d tokens in "
                    "%.3fs (%.1f tok/s)", tp.seconds, tp.tokens_per_s,
                    td.batch, args.gen, td.seconds, td.tokens_per_s)
        if i < args.restarts:
            tr = sess.restart()
            logger.info("in-place restart %d/%d: %.3fs", i + 1, args.restarts,
                        tr.seconds)
    logger.info("sample generation: %s", gen[0][:16].cpu().numpy())


if __name__ == "__main__":
    main()
