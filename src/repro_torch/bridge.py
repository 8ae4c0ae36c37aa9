"""Move parameters and optimizer state from the JAX package into the port.

The JAX package's parameters are a tree of nested dicts, lists and tuples; the
port keeps the same tree (``Model.specs``), so the bridge is a leaf-by-leaf
mapping. AdamW's state (m and v, trees shaped like the parameters, and the
step count) crosses the same way, so that both packages can start a train
step from the same state. The caller hands the trees over as numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``); nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def params_from_numpy(tree: Any, device: torch.device | str = "cpu") -> Any:
    """The same tree with every array leaf as a torch tensor on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def adam_state_from_numpy(m: Any, v: Any, step: int, device: torch.device | str = "cpu"):
    """The port's ``AdamState`` from the JAX package's m and v trees (as
    numpy arrays) and its step count."""
    from repro_torch.train.optimizer import AdamState
    return AdamState(m=params_from_numpy(m, device), v=params_from_numpy(v, device),
                     step=torch.tensor(int(step), dtype=torch.int32, device=device))
