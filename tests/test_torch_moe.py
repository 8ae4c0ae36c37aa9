"""The port's MoE FFN against the JAX package's (``repro.models.moe``) on
the same weights and inputs, made from a seed with numpy: the router, the
load-balancing loss, the dense all-experts path, the gathered decode path
and ``moe_forward`` with its shared experts and its choice of path. fp32
throughout: the two sides differ only by summation order, within 1e-5."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ParallelConfig as JaxParallel
from repro.config import get_smoke as jax_get_smoke
from repro.models import moe as jmoe
from repro_torch import config as tcfg
from repro_torch.models import moe as tmoe

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(arch: str = "deepseek-v2-lite-16b"):
    ref = dataclasses.replace(jax_get_smoke(arch), dtype="float32")
    d = dataclasses.asdict(ref)
    d["attention"] = tcfg.AttentionConfig(**d["attention"]) if d["attention"] else None
    d["moe"] = tcfg.MoEConfig(**d["moe"])
    d["ssm"] = tcfg.SSMConfig(**d["ssm"]) if d["ssm"] else None
    return ref, tcfg.ModelConfig(**d)


def _params(cfg, seed: int = 0) -> dict:
    """Seeded numpy weights shaped by the spec tree, at each spec's scale."""
    rng = np.random.default_rng(seed)
    specs = tmoe.moe_specs(cfg.d_model, cfg.moe, cfg.mlp_act)

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return (rng.standard_normal(s.shape) * s.stddev).astype(np.float32)
    return draw(specs)


def _both(tree):
    def j(t):
        return {k: j(v) for k, v in t.items()} if isinstance(t, dict) else jnp.asarray(t)

    def p(t):
        return {k: p(v) for k, v in t.items()} if isinstance(t, dict) else torch.from_numpy(t)
    return j(tree), p(tree)


def _x(shape, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mixtral-8x22b"])
def test_route_and_aux_loss_match_jax(arch):
    ref, cfg = _cfgs(arch)
    jp, tp = _both(_params(cfg))
    x = _x((40, cfg.d_model))
    jg, ji, jpr = jmoe._route(jp["router"], jnp.asarray(x), ref.moe)
    tg, ti, tpr = tmoe._route(tp["router"], torch.from_numpy(x), cfg.moe)
    np.testing.assert_array_equal(_np(ti), _np(ji))
    np.testing.assert_allclose(_np(tg), _np(jg), **TOL)
    np.testing.assert_allclose(_np(tpr), _np(jpr), **TOL)
    np.testing.assert_allclose(_np(tg.sum(-1)), 1.0, **TOL)
    E = cfg.moe.num_experts
    np.testing.assert_allclose(_np(tmoe._aux_loss(tpr, ti, E)),
                               _np(jmoe._aux_loss(jpr, ji, E)), **TOL)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mixtral-8x22b"])
@pytest.mark.parametrize("path", ["moe_dense", "moe_gather_decode"])
def test_moe_paths_match_jax(arch, path):
    ref, cfg = _cfgs(arch)
    jp, tp = _both(_params(cfg))
    x = _x((2, 7, cfg.d_model))
    jy, jaux = getattr(jmoe, path)(jp, ref.moe, jnp.asarray(x), act=ref.mlp_act,
                                   dtype=jnp.float32)
    ty, taux = getattr(tmoe, path)(tp, cfg.moe, torch.from_numpy(x), act=cfg.mlp_act,
                                   dtype=torch.float32)
    assert ty.shape == x.shape
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    np.testing.assert_allclose(_np(taux), _np(jaux), **TOL)


def test_gather_decode_equals_dense_on_the_same_tokens():
    """The two paths compute one function: on decode-sized inputs (one token
    per row) the gathered top-k experts give the dense path's output."""
    _, cfg = _cfgs()
    _, tp = _both(_params(cfg, seed=3))
    x = torch.from_numpy(_x((4, 1, cfg.d_model), seed=4))
    yd, ad = tmoe.moe_dense(tp, cfg.moe, x, act=cfg.mlp_act, dtype=torch.float32)
    yg, ag = tmoe.moe_gather_decode(tp, cfg.moe, x, act=cfg.mlp_act, dtype=torch.float32)
    np.testing.assert_allclose(_np(yg), _np(yd), **TOL)
    np.testing.assert_allclose(_np(ag), _np(ad), **TOL)


@pytest.mark.parametrize("decode,impl,B,S", [
    (False, "dense", 2, 7),       # prefill / training: dense
    (True, "dense", 2, 1),        # decode, the default decode_moe_impl
    (True, "gather", 1, 1),       # decode, gather: B*S*k = 2 < 4 experts -> gather
    (True, "gather", 2, 1),       # B*S*k = 4 < 4 is false -> dense
])
def test_moe_forward_with_shared_experts_matches_jax(decode, impl, B, S):
    """``moe_forward``: the routed experts on the path the reference picks,
    plus the shared experts, aux times router_aux_coef."""
    ref, cfg = _cfgs()
    assert cfg.moe.num_shared_experts == 1
    jp, tp = _both(_params(cfg, seed=5))
    assert "shared" in tp
    x = _x((B, S, cfg.d_model), seed=6)
    kw = dict(decode=decode)
    jy, jaux = jmoe.moe_forward(jp, ref, jnp.asarray(x), rules=None,
                                parallel=JaxParallel(decode_moe_impl=impl),
                                dtype=jnp.float32, **kw)
    ty, taux = tmoe.moe_forward(tp, cfg, torch.from_numpy(x),
                                parallel=tcfg.ParallelConfig(decode_moe_impl=impl),
                                dtype=torch.float32, **kw)
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    np.testing.assert_allclose(_np(taux), _np(jaux), **TOL)
    routed, _ = tmoe.moe_dense(tp, cfg.moe, torch.from_numpy(x), act=cfg.mlp_act,
                               dtype=torch.float32)
    assert not np.allclose(_np(ty), _np(routed))      # the shared experts add in


def test_moe_forward_picks_gather_as_the_reference_does(monkeypatch):
    """decode with ``decode_moe_impl="gather"`` and B*S*top_k < E runs the
    gathered path; every other case runs dense (no mesh)."""
    _, cfg = _cfgs()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=8))
    _, tp = _both(_params(cfg, seed=7))
    ran = []
    for name in ("moe_dense", "moe_gather_decode"):
        fn = getattr(tmoe, name)
        monkeypatch.setattr(tmoe, name, lambda *a, _fn=fn, _n=name, **k: (ran.append(_n),
                                                                         _fn(*a, **k))[1])
    gather = tcfg.ParallelConfig(decode_moe_impl="gather")
    for B, decode, par in [(3, True, gather), (4, True, gather), (3, False, gather),
                           (3, True, tcfg.ParallelConfig())]:
        x = torch.from_numpy(_x((B, 1, cfg.d_model), seed=B))
        tmoe.moe_forward(tp, cfg, x, parallel=par, decode=decode, dtype=torch.float32)
    # 3*1*2 = 6 < 8 gathers; 4*1*2 = 8 does not
    assert ran == ["moe_gather_decode", "moe_dense", "moe_dense", "moe_dense"]


def test_serving_launches_nothing_for_the_aux_loss(monkeypatch):
    """The load-balancing loss is computed in training only: prefill and
    decode skip ``_aux_loss`` (the reference drops it under jit) and return
    aux 0.0, with the same outputs; ``Model.loss`` still adds it."""
    from repro_torch.models.model import Model
    _, cfg = _cfgs()
    _, tp = _both(_params(cfg, seed=8))
    x = torch.from_numpy(_x((2, 3, cfg.d_model), seed=9))
    gather = tcfg.ParallelConfig(decode_moe_impl="gather")
    for decode, par in [(False, gather), (True, tcfg.ParallelConfig()),
                        (True, gather)]:
        kw = dict(parallel=par, decode=decode, dtype=torch.float32)
        y, aux = tmoe.moe_forward(tp, cfg, x[:, :1] if decode else x, **kw)
        y0, aux0 = tmoe.moe_forward(tp, cfg, x[:, :1] if decode else x,
                                    with_aux=False, **kw)
        assert torch.equal(y0, y) and aux0 == 0.0 and float(aux) > 0.0
    calls = []
    fn = tmoe._aux_loss
    monkeypatch.setattr(tmoe, "_aux_loss", lambda *a: (calls.append(1), fn(*a))[1])
    model = Model(cfg, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(10).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int64))
    _, caches = model.prefill({"tokens": tok[:, :5]})
    model.decode_step(caches, tok[:, 5], 5)
    assert calls == []
    n_moe = cfg.num_layers - cfg.moe.first_k_dense
    _, metrics = model.loss(model.params_tree(), {"tokens": tok, "labels": tok})
    assert len(calls) == n_moe and float(metrics["aux"]) > 0.0
