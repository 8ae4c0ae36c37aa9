"""ParamSpec: abstract parameter descriptions (shape + logical axes + init).

Models are built in two phases, as in the JAX package:
  1. ``*_specs(cfg)``  -> tree of ParamSpec (nested dicts, lists and tuples;
                          nothing allocated)
  2. ``init_params``   -> real tensors from the spec tree

Each leaf draws from its own ``torch.Generator``, seeded from the run seed and
an FNV hash of the leaf's path, so a leaf's values do not depend on which
other leaves exist. The draws are made on the CPU and then moved, so the same
seed gives the same weights on every device. They are not JAX's bits.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch


class ParamSpec(NamedTuple):
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]           # logical axis names per dim
    dtype: torch.dtype = torch.float32
    init: str = "normal"                      # normal | zeros | ones | a_log
    stddev: float = 0.02


def is_spec(x: Any) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn: Callable, tree: Any, *, is_leaf: Callable[[Any], bool] = is_spec,
             _path: tuple[str, ...] = ()) -> Any:
    """Map ``fn(path, leaf)`` over nested dicts, lists and tuples.

    ``path`` names each step as the JAX package's key paths print it
    (``['embed']``, ``[0]``), so path hashes agree with ``repro.models.spec``."""
    if is_leaf(tree):
        return fn(_path, tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf=is_leaf, _path=_path + (f"[{k!r}]",))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, is_leaf=is_leaf, _path=_path + (f"[{i}]",))
               for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(_path, tree)


def init_params(spec_tree: Any, seed: int, device: torch.device | str = "cpu") -> Any:
    """Materialize parameters. Deterministic per leaf via its path hash."""
    def one(path, spec):
        # the CPU generator keeps 32 bits of its seed: mix the run seed in
        # with a multiplicative hash rather than above bit 31
        mixed = (_stable_hash("/".join(path)) + seed * 2654435761) % (1 << 32)
        g = torch.Generator().manual_seed(mixed)
        return _init_one(spec, g).to(device)
    return tree_map(one, spec_tree)


def _init_one(spec: ParamSpec, g: torch.Generator) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype)
    if spec.init == "normal":
        x = torch.randn(spec.shape, generator=g, dtype=torch.float32) * spec.stddev
        return x.to(spec.dtype)
    if spec.init == "a_log":  # mamba: A in [1, 16), stored as log
        a = torch.rand(spec.shape, generator=g, dtype=torch.float32) * 15.0 + 1.0
        return torch.log(a).to(spec.dtype)
    raise ValueError(f"unknown init {spec.init!r}")


def _stable_hash(s: str) -> int:
    h = 2166136261
    for ch in s.encode():
        h = (h ^ ch) * 16777619 % (1 << 31)
    return h


def stack_specs(spec_tree: Any, n: int) -> Any:
    """Add a leading stacked-layers dim (logical axis "stacked")."""
    return tree_map(
        lambda _, s: ParamSpec((n,) + s.shape, ("stacked",) + s.axes,
                               s.dtype, s.init, s.stddev),
        spec_tree)


def num_params(spec_tree: Any) -> int:
    total = 0

    def count(_, s):
        nonlocal total
        total += int(torch.Size(s.shape).numel())
    tree_map(count, spec_tree)
    return total
