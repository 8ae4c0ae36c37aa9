"""Small shared utilities: the package logger, rounding, device choice."""
from __future__ import annotations

import logging
import math
from typing import Optional

import torch

logger = logging.getLogger("repro_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(asctime)s %(levelname)s %(name)s] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


def round_up(x: int, m: int) -> int:
    return int(math.ceil(x / m) * m)


def resolve_device(device: Optional[str | torch.device]) -> torch.device:
    """The card unless the caller asks for something else.

    ``None`` means ``cuda``; asking for ``cuda`` on a machine without a GPU
    raises instead of carrying on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return dev
