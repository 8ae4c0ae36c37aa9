"""Move parameters from the JAX package into the port.

The JAX package's parameters are a tree of nested dicts, lists and tuples; the
port keeps the same tree (``Model.specs``), so the bridge is a leaf-by-leaf
mapping. The caller hands the tree over as numpy arrays
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
