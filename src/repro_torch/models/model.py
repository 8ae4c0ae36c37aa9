"""The model: composes layers into segments of a repeating layer pattern.

The decomposition into segments is that of ``repro.models.model``: maximal
runs of a repeating layer pattern, each leaf of a segment's parameters
stacked over the pattern's repeats. The JAX package scans over the stack;
here a Python loop walks it. Keeping the stacked layout keeps the parameter
tree the JAX package's (``embed/tok``, ``segments[i]`` as a tuple of
per-layer dicts, ``final_norm/scale``), so weights move between the two
packages by a plain mapping (:mod:`repro_torch.bridge`).

The port implements the ``attn`` mixer (GQA and MLA) and the ``mamba`` mixer,
and the ``dense``, ``moe`` and ``none`` MLPs, in any pattern; cross-attention
and the modality frontends raise ``NotImplementedError`` naming their ROADMAP
item. Training (:meth:`Model.loss` under autograd) runs through the
flash-attention and RMSNorm backward kernels on the card; the SSD kernel has
no backward yet and raises there, and so does the flash backward at a head
dim it lacks (MLA's 192).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.spec import init_params, is_spec, stack_specs, tree_map
from repro_torch.utils import resolve_device

Params = Any
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Leaves the reference reads in fp32 whatever the compute dtype: RMSNorm
# scales (``scale``; mamba's gated-norm ``norm`` and MLA's ``kv_norm`` and
# ``q_norm``, which the RMSNorm kernel takes only in fp32), and mamba's
# ``A_log`` and ``dt_bias``, which feed the fp32 ``A = -exp(A_log)`` and
# ``softplus(dt + dt_bias)``.
_FP32_LEAVES = ("['scale']", "['norm']", "['kv_norm']", "['q_norm']", "['A_log']",
                "['dt_bias']")


# ---------------------------------------------------------------------------
# layer plans & segmentation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerPlan:
    mixer: str            # "attn" | "mamba"
    mlp: str              # "dense" | "moe"
    window: int           # 0 = full attention
    d_ff: int
    cross_attn: bool = False


def layer_plans(cfg: ModelConfig, *, decoder: bool = True) -> list[LayerPlan]:
    plans = []
    n = cfg.num_layers
    for i in range(n):
        mixer = "attn" if cfg.is_attn_layer(i) else "mamba"
        is_moe = cfg.moe.is_moe_layer(i)
        if mixer == "attn" and cfg.attention is not None:
            window = cfg.attention.layer_window(i)
        else:
            window = 0
        d_ff = cfg.d_ff
        if (not is_moe and cfg.moe.num_experts and i < cfg.moe.first_k_dense
                and cfg.moe.first_dense_ff):
            d_ff = cfg.moe.first_dense_ff
        mlp = "moe" if is_moe else ("dense" if d_ff > 0 else "none")
        plans.append(LayerPlan(mixer=mixer, mlp=mlp,
                               window=window, d_ff=d_ff,
                               cross_attn=decoder and cfg.family == "audio"))
    return plans


@dataclasses.dataclass(frozen=True)
class Segment:
    pattern: tuple[LayerPlan, ...]
    repeat: int


def segment_plans(plans: list[LayerPlan], max_period: int = 12) -> list[Segment]:
    segs: list[Segment] = []
    i, n = 0, len(plans)
    while i < n:
        best_p, best_r = 1, 1
        for p in range(1, min(max_period, n - i) + 1):
            r = 1
            while (i + (r + 1) * p <= n
                   and plans[i + r * p: i + (r + 1) * p] == plans[i: i + p]):
                r += 1
            if r > 1 and r * p > best_p * best_r:
                best_p, best_r = p, r
        segs.append(Segment(tuple(plans[i: i + best_p]), best_r))
        i += best_p * best_r
    return segs


# ---------------------------------------------------------------------------
# per-layer specs / apply
# ---------------------------------------------------------------------------

def _check_plan(cfg: ModelConfig, plan: LayerPlan) -> None:
    if plan.cross_attn:
        raise NotImplementedError(f"{cfg.name}: cross-attention is ROADMAP "
                                  "Queue 1 item 11 (encoder-decoder)")


def _layer_specs(cfg: ModelConfig, plan: LayerPlan) -> dict:
    _check_plan(cfg, plan)
    d = cfg.d_model
    specs: dict = {"ln1": L.rmsnorm_specs(d)}
    if plan.mixer == "attn":
        specs["attn"] = attn_lib.attn_specs(cfg.attention, d)
    else:
        specs["mamba"] = mamba_lib.mamba_specs(cfg.ssm, d)
    if plan.mlp != "none":
        specs["ln2"] = L.rmsnorm_specs(d)
    if plan.mlp == "moe":
        specs["moe"] = moe_lib.moe_specs(d, cfg.moe, cfg.mlp_act)
    elif plan.mlp == "dense":
        specs["mlp"] = L.mlp_specs(d, plan.d_ff, cfg.mlp_act)
    return specs


def model_specs(cfg: ModelConfig) -> dict:
    """The parameter spec tree, in the JAX package's layout (no allocation)."""
    specs: dict = {"embed": L.embed_specs(cfg)}
    specs["segments"] = [
        stack_specs(tuple(_layer_specs(cfg, p) for p in seg.pattern), seg.repeat)
        for seg in segment_plans(layer_plans(cfg))]
    specs["final_norm"] = L.rmsnorm_specs(cfg.d_model)
    head = L.lm_head_specs(cfg)
    if head:
        specs["lm_head"] = head
    return specs


def _cache_len(cfg: ModelConfig, plan: LayerPlan) -> int:
    if plan.window > 0:
        return min(plan.window, cfg.max_seq_len)
    return cfg.max_seq_len


def _apply_layer(cfg: ModelConfig, parallel: ParallelConfig, plan: LayerPlan,
                 params: Params, h: torch.Tensor, *, positions, dtype, mode: str,
                 cache: Optional[dict], cur_index: Optional[int],
                 max_cache_len: int = 0) -> tuple[torch.Tensor, dict, torch.Tensor]:
    """Returns (h, new_cache, aux): aux is the MoE load-balancing loss of
    the layer (already times ``router_aux_coef``) in ``mode == "train"``,
    the number 0.0 otherwise and for other MLPs (serving launches nothing
    for it)."""
    new_cache: dict = {}
    aux = 0.0
    acfg = cfg.attention
    mla = acfg is not None and acfg.kind == "mla"
    x = L.rmsnorm(params["ln1"], h, cfg.norm_eps)
    if plan.mixer == "mamba":
        kw = dict(d_model=cfg.d_model, dtype=dtype, norm_eps=cfg.norm_eps)
        if mode == "decode":
            y, new_cache["ssm"] = mamba_lib.mamba_decode(
                params["mamba"], cfg.ssm, x, cache["ssm"], **kw)
        elif mode == "prefill":
            y, new_cache["ssm"] = mamba_lib.mamba_forward(
                params["mamba"], cfg.ssm, x, return_state=True, **kw)
        else:
            y = mamba_lib.mamba_forward(params["mamba"], cfg.ssm, x, **kw)
    elif mode == "decode":
        if mla:
            y, new_cache["kv"] = attn_lib.mla_decode(
                params["attn"], acfg, x, cache["kv"], cur_index, dtype=dtype)
        else:
            y, new_cache["kv"] = attn_lib.gqa_decode(
                params["attn"], acfg, x, cache["kv"], cur_index,
                window=plan.window, dtype=dtype)
    else:
        if mla:
            y = attn_lib.mla_forward(params["attn"], acfg, x, positions, dtype=dtype)
        else:
            y = attn_lib.gqa_forward(params["attn"], acfg, x, positions,
                                     window=plan.window, dtype=dtype)
        if mode == "prefill":
            # ring-buffer length: the window (SWA) or the decode horizon
            # (defaults to the model max)
            horizon = max_cache_len or cfg.max_seq_len
            cache_len = min(_cache_len(cfg, plan), max(horizon, x.shape[1]))
            prefill_cache = attn_lib.mla_prefill_cache if mla else attn_lib.gqa_prefill_cache
            new_cache["kv"] = prefill_cache(params["attn"], acfg, x, positions,
                                            cache_len, dtype)
    h = h + y
    if plan.mlp == "none":
        return h, new_cache, aux
    x2 = L.rmsnorm(params["ln2"], h, cfg.norm_eps)
    if plan.mlp == "moe":
        y, aux = moe_lib.moe_forward(params["moe"], cfg, x2, parallel=parallel,
                                     decode=(mode == "decode"), dtype=dtype,
                                     with_aux=(mode == "train"))
    else:
        y = L.mlp(params["mlp"], x2, cfg.mlp_act, dtype)
    return h + y, new_cache, aux


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

class _Node(nn.Module):
    """A dict of tensors and subtrees side by side (an MoE layer's experts
    beside its ``shared`` MLP), indexed by key."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))
            else:
                self.add_module(k, _as_module(v))

    def __getitem__(self, key: str):
        return getattr(self, key)


def _as_module(tree: Any) -> nn.Module:
    """Nested dicts/lists/tuples of tensors as ModuleDict/ParameterDict/
    ModuleList (and :class:`_Node` for a dict that mixes tensors and
    subtrees)."""
    if isinstance(tree, dict):
        leaves = [isinstance(v, torch.Tensor) for v in tree.values()]
        if all(leaves):
            return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                     for k, v in tree.items()})
        if any(leaves):
            return _Node(tree)
        return nn.ModuleDict({k: _as_module(v) for k, v in tree.items()})
    return nn.ModuleList([_as_module(v) for v in tree])


def _as_tree(mod: Any, like: Any) -> Any:
    """Inverse of :func:`_as_module`, shaped like ``like`` (whose leaves may
    be tensors or ParamSpecs)."""
    if isinstance(like, dict):
        return {k: _as_tree(mod[k], v) for k, v in like.items()}
    if isinstance(like, (list, tuple)) and not is_spec(like):
        return type(like)(_as_tree(m, v) for m, v in zip(mod, like))
    return mod


class Model(nn.Module):
    """The model with its parameters, on one device.

    Parameters are fp32 ``nn.Parameter``s in the JAX package's tree layout.
    Serving (:meth:`forward_logits`, :meth:`prefill`, :meth:`decode_step`)
    reads compute-dtype copies of them, made once and kept, not at every use:
    the numbers are identical and a decode step then reads bf16 weights only.
    The leaves the reference reads in fp32 (``_FP32_LEAVES``) stay fp32. The
    copies are made at the first serving call after the parameters were set
    or changed: :meth:`load_params` and :meth:`params_changed` (which the
    train step calls after its in-place update) drop them.

    Training (:meth:`loss`) takes the parameter tree as an argument, as the
    JAX package's does, and casts each leaf where it is used, so autograd
    differentiates the tree it is given. ``parallel.remat`` ``"full"``
    recomputes each repeat of a segment's layer pattern in the backward pass
    (``torch.utils.checkpoint``); ``"dots"`` does the same: the port keeps no
    matmul outputs selectively, which changes memory and time, not numbers.
    """

    def __init__(self, cfg: ModelConfig, parallel: Optional[ParallelConfig] = None, *,
                 device=None, seed: int = 0):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        self.parallel = parallel if parallel is not None else ParallelConfig()
        if self.parallel.remat not in ("none", "full", "dots"):
            raise ValueError(f"remat {self.parallel.remat!r}")
        if self.parallel.grad_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"grad_dtype {self.parallel.grad_dtype!r}")
        self.device = resolve_device(device)
        self.dtype = _DTYPES[cfg.dtype]
        self.plans = layer_plans(cfg)
        self.segments = segment_plans(self.plans)
        if cfg.family == "audio" or cfg.frontend != "none":
            raise NotImplementedError(f"{cfg.name}: frontends are ROADMAP "
                                      "Queue 1 item 11")
        self.load_params(init_params(self.specs(), seed, self.device))

    # -- specs / parameters -------------------------------------------------

    def specs(self) -> dict:
        return model_specs(self.cfg)

    def load_params(self, tree: Params) -> None:
        """Set every parameter from a tree shaped like :meth:`specs`."""
        def check(path, spec, t):
            if tuple(t.shape) != spec.shape:
                raise ValueError(f"{'/'.join(path)}: shape {tuple(t.shape)} "
                                 f"!= {spec.shape}")
            return t.to(device=self.device, dtype=spec.dtype)
        flat = _flatten(tree)
        tree = tree_map(lambda path, s: check(path, s, flat["/".join(path)]),
                        self.specs())
        self.params = _as_module(tree)
        self._compute_tree = None

    def params_changed(self) -> None:
        """Drop the serving copies: the parameters were changed in place.
        The next serving call casts them anew."""
        self._compute_tree = None

    @property
    def _compute(self) -> Params:
        if self._compute_tree is None:
            self._compute_tree = tree_map(
                lambda path, t: t if path[-1] in _FP32_LEAVES else t.to(self.dtype),
                self.params_tree(), is_leaf=_is_tensor)
        return self._compute_tree

    def params_tree(self) -> Params:
        """The fp32 parameters as nested dicts/lists/tuples of tensors (the
        model's own: an in-place change to them changes the model)."""
        return _as_tree(self.params, self.specs())

    # -- stacks -------------------------------------------------------------

    def _run_segments(self, p, h, *, positions, mode, caches=None,
                      cur_index=None, max_cache_len=0):
        """Apply all segments of the parameter tree ``p``; returns (h,
        new_caches, aux), aux summed over the layers.

        Each stacked leaf is unbound once into its repeats: autograd then
        stacks their gradients in one operation (indexing each repeat would
        add a zero-filled full-size gradient per repeat). A layer's cache is
        a dict keyed as the reference keys it (``{"kv": {...}}`` or
        ``{"ssm": {...}}``), each leaf stacked over the segment's repeats.
        Decode hands each layer views of its slice of the stack, which the
        layer updates in place. In training under autograd with remat on,
        each repeat of the pattern is a ``torch.utils.checkpoint`` region."""
        cfg = self.cfg
        remat = (mode == "train" and self.parallel.remat != "none"
                 and torch.is_grad_enabled())
        new_caches = []
        aux = 0.0                       # a tensor once an MoE layer adds to it
        for si, seg in enumerate(self.segments):
            built = [[] for _ in seg.pattern]     # prefill: one cache per repeat
            layers = [tree_map(lambda _, t: t.unbind(0), lp, is_leaf=_is_tensor)
                      for lp in p["segments"][si]]
            for r in range(seg.repeat):
                if remat:
                    def body(hh, _seg=seg, _layers=layers, _r=r):
                        total = 0.0
                        for plan, lp in zip(_seg.pattern, _layers):
                            hh, _, a = _apply_layer(
                                cfg, self.parallel, plan,
                                tree_map(lambda _, t: t[_r], lp, is_leaf=_is_tuple),
                                hh, positions=positions, dtype=self.dtype, mode=mode,
                                cache=None, cur_index=None)
                            total = total + a
                        return hh, total
                    h, a = torch.utils.checkpoint.checkpoint(body, h, use_reentrant=False)
                    aux = aux + a
                    continue
                for li, plan in enumerate(seg.pattern):
                    lp = tree_map(lambda _, t: t[r], layers[li], is_leaf=_is_tuple)
                    c = None
                    if caches is not None:
                        c = tree_map(lambda _, t: t[r], caches[si][li],
                                     is_leaf=_is_tensor)
                    h, nc, a = _apply_layer(cfg, self.parallel, plan, lp, h,
                                            positions=positions, dtype=self.dtype,
                                            mode=mode, cache=c, cur_index=cur_index,
                                            max_cache_len=max_cache_len)
                    aux = aux + a
                    built[li].append(nc)
            if mode == "decode":
                new_caches.append(caches[si])     # updated in place
            elif mode == "prefill":
                new_caches.append(tuple(_stack(cs) for cs in built))
        return h, new_caches, aux

    # -- public entry points ------------------------------------------------

    def hidden_states(self, batch: dict, mode: str = "train",
                      max_cache_len: int = 0, params: Optional[Params] = None):
        """Full-sequence forward to final hidden states, with ``params`` (a
        tree shaped like :meth:`specs`) or the serving copies.

        Returns (h, caches, aux); caches is None unless ``mode ==
        "prefill"``; aux is the MoE load-balancing loss summed over the
        layers (a tensor) in ``mode == "train"``, else 0.0, and 0.0 without
        MoE layers."""
        cfg = self.cfg
        p = self._compute if params is None else params
        tok = batch["tokens"]
        h = L.embed(p["embed"], tok, self.dtype, cfg.d_model)
        positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
        h, caches, aux = self._run_segments(p, h, positions=positions, mode=mode,
                                            max_cache_len=max_cache_len)
        h = L.rmsnorm(p["final_norm"], h, cfg.norm_eps)
        return h, (caches if mode == "prefill" else None), aux

    def logits_fn(self, params: Optional[Params] = None):
        p = self._compute if params is None else params

        def fn(h: torch.Tensor) -> torch.Tensor:
            return L.lm_head(p.get("lm_head"), p["embed"], h,
                             self.cfg.tie_embeddings, self.dtype)
        return fn

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        return self.logits_fn()(h)

    def loss(self, params: Params, batch: dict):
        """Mean cross-entropy (+ z-loss + MoE aux). Returns (loss, metrics)
        as the JAX package's ``Model.loss`` does. The z-loss weight is the reference's ``getattr(self, "z_loss",
        1e-4)``, which ignores ``TrainConfig.z_loss`` (kept, so that the
        numbers match; ROADMAP Queue 3)."""
        h, _, aux = self.hidden_states(batch, mode="train", params=params)
        weights = batch.get("weights")
        if weights is None:
            weights = torch.ones(batch["tokens"].shape, dtype=torch.float32,
                                 device=h.device)
        z = getattr(self, "z_loss", 1e-4)
        total, wsum = L.softmax_xent_chunked(self.logits_fn(params), h, batch["labels"],
                                             weights, z_loss=z)
        xent = total / torch.clamp(wsum, min=1.0)
        aux = torch.as_tensor(aux, dtype=torch.float32, device=h.device)
        loss = xent + aux
        return loss, {"loss": loss, "xent": xent, "aux": aux, "tokens": wsum}

    @torch.no_grad()
    def forward_logits(self, batch: dict) -> torch.Tensor:
        """(B, S, V) logits — for small-model evaluation/serving checks."""
        h, _, _ = self.hidden_states(batch, mode="train")
        return self.logits(h)

    @torch.no_grad()
    def prefill(self, batch: dict, max_cache_len: int = 0):
        """Run the prompt, build caches. Returns (last_logits, caches).

        ``max_cache_len`` sizes the full-attention ring buffers (the decode
        horizon); 0 means the model's max context."""
        h, caches, _ = self.hidden_states(batch, mode="prefill",
                                          max_cache_len=max_cache_len)
        return self.logits(h[:, -1:])[:, 0], caches

    @torch.no_grad()
    def decode_step(self, caches, tokens: torch.Tensor, cur_index: int):
        """One decode step. tokens: (B,) int; cur_index: absolute position.

        Returns (logits (B, V), caches); the caches are updated in place."""
        cfg = self.cfg
        h = L.embed(self._compute["embed"], tokens[:, None], self.dtype, cfg.d_model)
        h, caches, _ = self._run_segments(self._compute, h, positions=None,
                                          mode="decode", caches=caches,
                                          cur_index=int(cur_index))
        h = L.rmsnorm(self._compute["final_norm"], h, cfg.norm_eps)
        return self.logits(h)[:, 0], caches

    def init_caches(self, batch: int, prompt_len: int) -> list:
        """Zero caches (empty slots) sized for a ``prompt_len`` context."""
        cfg = self.cfg
        caches = []
        for seg in self.segments:
            pattern = []
            for plan in seg.pattern:
                if plan.mixer == "attn":
                    clen = min(_cache_len(cfg, plan), max(prompt_len, 1))
                    init = (attn_lib.mla_cache_init if cfg.attention.kind == "mla"
                            else attn_lib.gqa_cache_init)
                    c = {"kv": init(cfg.attention, batch, clen, self.dtype, self.device)}
                else:
                    c = {"ssm": mamba_lib.mamba_cache_init(
                        cfg.ssm, batch, cfg.d_model, self.dtype, self.device)}
                pattern.append(tree_map(
                    lambda _, t: t[None].repeat((seg.repeat,) + (1,) * t.dim()),
                    c, is_leaf=_is_tensor))
            caches.append(tuple(pattern))
        return caches


def _is_tensor(x: Any) -> bool:
    return isinstance(x, torch.Tensor)


def _is_tuple(x: Any) -> bool:
    """A leaf unbound into its repeats (a tuple of tensors)."""
    return isinstance(x, tuple) and len(x) > 0 and isinstance(x[0], torch.Tensor)


def _stack(trees: list) -> Any:
    """Nested dicts of tensors, shaped alike, stacked leaf by leaf."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _flatten(tree: Any, path: tuple[str, ...] = ()) -> dict[str, Any]:
    """{"['a']/[0]/...": leaf} over nested dicts/lists/tuples."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, path + (f"[{k!r}]",)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, path + (f"[{i}]",)))
        return out
    return {"/".join(path): tree}
