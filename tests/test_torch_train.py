"""The port's training half on the CPU against the JAX package's: the data
pipeline, the chunked loss, AdamW, and the train step itself, on the same
weights (through the bridge), the same optimizer state and the same batches.

The JAX side runs ``jax.jit(make_train_step(...))`` without a mesh, with its
Pallas kernels off (``runtime.STATE.use_pallas`` is False by default), so its
gradients are autodiff of the jnp oracles (``flash_attention_jnp``,
``layers.rmsnorm``); the port's go through its backward wrappers, which on
CPU tensors run their plain versions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as jdata
from repro.config import ParallelConfig as JaxParallel
from repro.config import TrainConfig as JaxTrain
from repro.config import get_smoke as jax_get_smoke
from repro.kernels import runtime
from repro.models import Model as JaxModel
from repro.models import layers as JL
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch import config as tcfg
from repro_torch import data as tdata
from repro_torch.bridge import adam_state_from_numpy, params_from_numpy
from repro_torch.models import Model
from repro_torch.models import layers as TL
from repro_torch.train import make_train_step
from repro_torch.train import optimizer as topt


def port_config(cfg) -> tcfg.ModelConfig:
    d = dataclasses.asdict(cfg)
    d["attention"] = tcfg.AttentionConfig(**d["attention"]) if d["attention"] else None
    d["moe"] = tcfg.MoEConfig(**d["moe"])
    d["ssm"] = tcfg.SSMConfig(**d["ssm"]) if d["ssm"] else None
    return tcfg.ModelConfig(**d)


def to_port(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x, np.float64)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

DATA = dict(vocab_size=512, seq_len=33, global_batch=3)


@pytest.mark.parametrize("seed,motif_prob", [(0, 0.5), (3, 0.8), (11, 0.0)])
def test_synthetic_batches_equal_jax_bit_for_bit(seed, motif_prob):
    kw = dict(DATA, seed=seed, motif_prob=motif_prob)
    ours = tdata.SyntheticLM(tdata.DataConfig(**kw))
    theirs = jdata.SyntheticLM(jdata.DataConfig(**kw))
    for step in (0, 1, 7, 1000):
        a, b = ours.batch(step), theirs.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])


def test_loader_skip_and_state_round_trip_equal_jax():
    kw = dict(DATA, seed=5)
    ours = tdata.DataLoader(tdata.SyntheticLM(tdata.DataConfig(**kw)), start_step=2)
    theirs = jdata.DataLoader(jdata.SyntheticLM(jdata.DataConfig(**kw)), start_step=2)
    ours.skip(4, 7)
    theirs.skip(4, 7)
    steps = []
    for _ in range(4):
        (sa, a), (sb, b) = ours.next(), theirs.next()
        assert sa == sb
        steps.append(sa)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert steps == [2, 3, 7, 8]
    restored = tdata.DataLoader(tdata.SyntheticLM(tdata.DataConfig(**kw)))
    restored.load_state_dict(ours.state_dict())
    assert restored.state_dict() == theirs.state_dict()
    for _ in range(3):
        (sa, a), (sb, b) = restored.next(), theirs.next()
        assert sa == sb
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,chunk", [(24, 8), (30, 8), (7, 1024), (1030, 1024)])
@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_softmax_xent_chunked_matches(S, chunk, z_loss):
    """fp32 to 1e-5 relative: chunks, the ragged remainder chunk, z-loss, and
    padded vocab columns (50 real, 64 in the head), which enter the
    logsumexp in both packages."""
    rng = np.random.default_rng(S + chunk)
    B, d, vocab, padded = 2, 16, 50, 64
    h = rng.standard_normal((B, S, d), dtype=np.float32)
    w = rng.standard_normal((d, padded), dtype=np.float32)
    labels = rng.integers(0, vocab, (B, S), dtype=np.int32)
    weights = (rng.random((B, S)) < 0.8).astype(np.float32)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    want = JL.softmax_xent_chunked(lambda x: x @ jw, jnp.asarray(h), jnp.asarray(labels),
                                   jnp.asarray(weights), chunk=chunk, z_loss=z_loss)
    got = TL.softmax_xent_chunked(lambda x: x @ tw, torch.from_numpy(h),
                                  torch.from_numpy(labels), torch.from_numpy(weights),
                                  chunk=chunk, z_loss=z_loss)
    for g, x in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == ()
        np.testing.assert_allclose(_np(g), _np(x), rtol=1e-5)
    # the padded columns count: without them the loss is another number
    real = TL.softmax_xent_chunked(lambda x: x @ tw[:, :vocab], torch.from_numpy(h),
                                   torch.from_numpy(labels), torch.from_numpy(weights),
                                   chunk=chunk, z_loss=z_loss)
    assert abs(float(real[0]) - float(got[0])) > 1e-3 * abs(float(got[0]))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _tree(rng, scale=1.0):
    return {"w": rng.standard_normal((6, 5), dtype=np.float32) * scale,
            "layers": ({"a": rng.standard_normal((7,), dtype=np.float32) * scale},
                       {"a": rng.standard_normal((7,), dtype=np.float32) * scale}),
            "b": [rng.standard_normal((3, 2, 2), dtype=np.float32) * scale]}


def _jtree(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _assert_trees(got, want, rtol, atol=0.0):
    gl, wl = topt.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(_np(g), _np(w), rtol=rtol, atol=atol)


def test_lr_schedule_matches():
    cfg = dict(learning_rate=3e-4, warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 9, 10, 11, 40, 99, 100, 150):
        want = jopt.lr_schedule(JaxTrain(**cfg), jnp.int32(step))
        got = topt.lr_schedule(tcfg.TrainConfig(**cfg), torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, err_msg=f"step {step}")


@pytest.mark.parametrize("max_norm", [0.1, 1e3])
def test_clip_by_global_norm_matches(max_norm):
    g = _tree(np.random.default_rng(1))
    want, wnorm = jopt.clip_by_global_norm(_jtree(g), max_norm)
    got, norm = topt.clip_by_global_norm(params_from_numpy(g), max_norm)
    np.testing.assert_allclose(_np(norm), _np(wnorm), rtol=1e-6)
    _assert_trees(got, want, rtol=1e-6)


@pytest.mark.parametrize("step", [0, 3])
def test_adamw_update_matches(step):
    """One update from the same (params, grads, m, v, step): params, m and v
    to 1e-6 relative (fp32 rounding of the same formula)."""
    rng = np.random.default_rng(step)
    p, g = _tree(rng), _tree(rng, 3.0)
    m, v = _tree(rng, 0.1), jax.tree_util.tree_map(np.abs, _tree(rng, 0.1))
    cfg = dict(learning_rate=1e-2, warmup_steps=2, total_steps=20)
    jstate = jopt.AdamState(_jtree(m), _jtree(v), jnp.int32(step))
    wp, ws, wmet = jopt.adamw_update(_jtree(g), jstate, _jtree(p), JaxTrain(**cfg))
    tstate = topt.AdamState(params_from_numpy(m), params_from_numpy(v),
                            torch.tensor(step, dtype=torch.int32))
    tp = params_from_numpy(p)
    gp, gs, gmet = topt.adamw_update(params_from_numpy(g), tstate, tp, tcfg.TrainConfig(**cfg))
    assert gp is tp and int(gs.step) == int(ws.step) == step + 1   # in place
    _assert_trees(gp, wp, rtol=1e-6, atol=1e-7)
    _assert_trees(gs.m, ws.m, rtol=1e-6, atol=1e-8)
    _assert_trees(gs.v, ws.v, rtol=1e-6, atol=1e-8)
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(_np(gmet[k]), _np(wmet[k]), rtol=1e-6)


def test_compress_grads_matches_and_feeds_back_error():
    rng = np.random.default_rng(2)
    g = _tree(rng)
    want, wst = jopt.compress_grads(_jtree(g), jopt.compressor_init(_jtree(g)))
    got, st = topt.compress_grads(params_from_numpy(g), topt.compressor_init(params_from_numpy(g)))
    _assert_trees(got, want, rtol=1e-6, atol=1e-7)
    _assert_trees(st.error, wst.error, rtol=1e-5, atol=1e-7)
    # error feedback: the average of 16 compressed copies of one gradient is
    # closer to it than one compression (the port's twin of
    # tests/test_train_and_data.py's check)
    w = {"w": torch.from_numpy(rng.standard_normal((64, 64), dtype=np.float32))}
    state, total = topt.compressor_init(w), torch.zeros(64, 64)
    for _ in range(16):
        deq, state = topt.compress_grads(w, state)
        total = total + deq["w"]
    one, _ = topt.compress_grads(w, topt.compressor_init(w))
    assert (total / 16 - w["w"]).abs().max() < (one["w"] - w["w"]).abs().max() / 2


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

TRAIN = dict(global_batch=4, seq_len=24, microbatches=2, learning_rate=1e-3,
             warmup_steps=2, total_steps=8)


def _batch(rng, vocab, B=4, S=24) -> dict:
    toks = rng.integers(0, vocab, (B, S + 1), dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "weights": (rng.random((B, S)) < 0.9).astype(np.float32)}


def _update(m, v, step: int, cfg: dict) -> np.ndarray:
    """AdamW's m_hat / (sqrt(v_hat) + eps) in fp64."""
    tc = JaxTrain(**cfg)
    return (m / (1 - tc.adam_b1 ** step)) / (np.sqrt(v / (1 - tc.adam_b2 ** step))
                                             + tc.adam_eps)


def _gate(cfg, *, grad_dtype: str, steps: int = 2, remat: str = "none"):
    """Steps of both train steps, each from the same state (JAX's, carried
    across: parameters, m, v and the step count). Yields, per step, the two
    metrics dicts and the (path, port, jax) leaves of params, m, v, and the
    AdamW update each framework's own new m and v imply."""
    jm = JaxModel(cfg, JaxParallel(remat="none", grad_dtype=grad_dtype))
    params = jm.init(jax.random.PRNGKey(0))
    tm = Model(port_config(cfg), tcfg.ParallelConfig(remat=remat, grad_dtype=grad_dtype),
               device="cpu")
    assert not runtime.STATE.use_pallas
    jstep = jax.jit(jax_make_train_step(jm, JaxTrain(**TRAIN)))
    tstep = make_train_step(tm, tcfg.TrainConfig(**TRAIN))
    jstate = jopt.adamw_init(params)
    rng = np.random.default_rng(7)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    for _ in range(steps):
        batch = _batch(rng, cfg.vocab_size)
        tm.load_params(to_port(params))
        tp = tm.params_tree()
        tstate = adam_state_from_numpy(*jax.tree_util.tree_map(np.asarray, (jstate.m, jstate.v)),
                                       int(jstate.step))
        params, jstate, jmet = jstep(params, jstate, {k: jnp.asarray(x) for k, x in batch.items()})
        tp, tstate, tmet = tstep(tp, tstate, {k: torch.from_numpy(x) for k, x in batch.items()})
        step = int(jstate.step)
        assert int(tstate.step) == step
        leaves = {}
        for name, ours, theirs in (("params", tp, params), ("m", tstate.m, jstate.m),
                                   ("v", tstate.v, jstate.v)):
            leaves[name] = list(zip(paths, map(_np, topt.tree_leaves(ours)),
                                    map(_np, jax.tree_util.tree_leaves(theirs))))
        leaves["update"] = [
            (path, _update(mt, vt, step, TRAIN), _update(mj, vj, step, TRAIN))
            for (path, mt, mj), (_, vt, vj) in zip(leaves["m"], leaves["v"])]
        yield tmet, jmet, leaves


def _check_step(tmet, jmet, leaves, *, mv_tol, norm_rtol=1e-5):
    """Loss to 1e-5 relative, the gradient norm to ``norm_rtol``; m and v
    per element to ``mv_tol``
    (a function of the JAX leaf); each parameter to 1e-5 of its leaf's
    largest |value| plus lr times the difference of the two AdamW updates.
    That last term is there because Adam divides m by sqrt(v) + eps: an
    element whose gradient is near eps (1e-8) or below moves by up to lr
    when its gradient moves by its own size, and fp32 summation in another
    order moves a gradient of 1e-9 by that much. It is computed from each
    framework's own m and v (held above), so it excuses no error of the
    update itself."""
    for k in ("loss", "xent", "lr", "tokens"):
        np.testing.assert_allclose(_np(tmet[k]), _np(jmet[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(_np(tmet["grad_norm"]), _np(jmet["grad_norm"]),
                               rtol=norm_rtol)
    for name in ("m", "v"):
        for path, ours, theirs in leaves[name]:
            bad = np.abs(ours - theirs) > mv_tol(theirs)
            assert not bad.any(), (f"{name} {path}: {bad.sum()} of {bad.size} elements, "
                                   f"max |d| {np.abs(ours - theirs).max():.3e}")
    lr = float(jmet["lr"])
    for (path, ours, theirs), (_, ut, uj) in zip(leaves["params"], leaves["update"]):
        limit = 1e-5 * np.abs(theirs).max() + 1.001 * lr * np.abs(ut - uj)
        bad = np.abs(ours - theirs) > limit
        assert not bad.any(), (f"params {path}: {bad.sum()} of {bad.size} elements, "
                               f"max |d| {np.abs(ours - theirs).max():.3e}")


@pytest.mark.parametrize("which", ["tiny", "smollm-360m smoke", "deepseek-v2-lite-16b smoke"])
def test_train_step_matches_jax_fp32(which, tiny_cfg):
    """fp32 compute and gradients, 2 microbatches, after step 1 and step 2:
    m and v to 1e-5 of each leaf's largest |value| (the target; fp32
    summation order gives ~2e-6). The deepseek smoke config trains MLA (the
    plain flash gradient at head dim 24) and MoE, whose loss adds the
    router's load-balancing aux (no mesh: the reference runs its dense
    path)."""
    cfg = tiny_cfg if which == "tiny" else jax_get_smoke(which.split()[0])
    cfg = dataclasses.replace(cfg, dtype="float32")
    for tmet, jmet, leaves in _gate(cfg, grad_dtype="float32"):
        _check_step(tmet, jmet, leaves, mv_tol=lambda ref: 1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("which", ["tiny", "smollm-360m smoke"])
def test_train_step_matches_jax_bf16_grads(which, tiny_cfg):
    """``grad_dtype="bfloat16"`` (fp32 compute): both differentiate a bf16
    cast of the parameters, so each microbatch gradient is an fp32 value
    rounded to bf16, and where the two fp32 values straddle a rounding
    boundary the two land one bf16 ulp (2**-8 relative) apart; two
    microbatches are summed. m and v per element: 2**-7 of |m|, |v| (v
    squares the gradient) plus 2**-8 of the leaf's largest |value| (a sum of
    two gradients of opposite sign keeps their ulps and loses their size);
    the gradient norm to 2**-8 relative."""
    cfg = tiny_cfg if which == "tiny" else jax_get_smoke("smollm-360m")
    cfg = dataclasses.replace(cfg, dtype="float32")
    for tmet, jmet, leaves in _gate(cfg, grad_dtype="bfloat16"):
        _check_step(tmet, jmet, leaves, norm_rtol=2.0 ** -8,
                    mv_tol=lambda ref: 2.0 ** -7 * np.abs(ref) + 2.0 ** -8 * np.abs(ref).max())


def test_train_step_bf16_compute_near_jax(tiny_cfg):
    """The configs' own dtype, bf16 compute: the two packages round
    activations and gradients to bf16 at different places (the jnp oracle
    rounds P before P V, the port's plain flash keeps it fp32), so this is a
    smoke check of the bf16 path, not evidence: loss to 1e-3 relative, m and
    v to 5% of each leaf's largest |value|."""
    for tmet, jmet, leaves in _gate(tiny_cfg, grad_dtype="float32", steps=1):
        np.testing.assert_allclose(_np(tmet["loss"]), _np(jmet["loss"]), rtol=1e-3)
        for name in ("m", "v"):
            for path, ours, theirs in leaves[name]:
                assert np.abs(ours - theirs).max() <= 0.05 * np.abs(theirs).max(), path


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_changes_no_number(remat, tiny_cfg):
    """Per-layer recompute (torch.utils.checkpoint) against none: the same
    bits after two steps, in fp32 and in bf16."""
    for dtype in ("float32", "bfloat16"):
        cfg = port_config(dataclasses.replace(tiny_cfg, dtype=dtype))
        out = []
        for r in ("none", remat):
            model = Model(cfg, tcfg.ParallelConfig(remat=r), device="cpu", seed=3)
            params, state = model.params_tree(), topt.adamw_init(model.params_tree())
            step = make_train_step(model, tcfg.TrainConfig(**TRAIN))
            rng = np.random.default_rng(4)
            for _ in range(2):
                batch = {k: torch.from_numpy(x) for k, x in _batch(rng, cfg.vocab_size).items()}
                params, state, met = step(params, state, batch)
            out.append([met["loss"]] + topt.tree_leaves((params, state.m, state.v)))
        for a, b in zip(*out):
            assert torch.equal(a, b), dtype


def test_microbatch_accumulation_matches_full_batch(tiny_cfg):
    """The port's twin of tests/test_train_and_data.py: 1 and 2 microbatches
    of the same batch give the same update up to accumulation order."""
    cfg = port_config(dataclasses.replace(tiny_cfg, dtype="float32"))
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(x) for k, x in _batch(rng, cfg.vocab_size, S=16).items()}
    batch["weights"] = torch.ones_like(batch["weights"])
    out = []
    for k in (1, 2):
        model = Model(cfg, tcfg.ParallelConfig(remat="none"), device="cpu")
        params = model.params_tree()
        tc = tcfg.TrainConfig(global_batch=4, seq_len=16, microbatches=k)
        params, _, met = make_train_step(model, tc)(params, topt.adamw_init(params), batch)
        out.append(topt.tree_leaves(params))
    for a, b in zip(*out):
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-4, atol=2e-4)


def test_loss_decreases_on_learnable_data(tiny_cfg):
    """The port's twin of tests/test_train_and_data.py: bf16 compute, 45
    steps on the synthetic motifs."""
    cfg = port_config(tiny_cfg)
    model = Model(cfg, tcfg.ParallelConfig(remat="none"), device="cpu")
    ds = tdata.SyntheticLM(tdata.DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                            global_batch=4, motif_prob=0.8))
    tc = tcfg.TrainConfig(global_batch=4, seq_len=32, learning_rate=3e-3,
                          warmup_steps=5, total_steps=60)
    step = make_train_step(model, tc)
    params = model.params_tree()
    state = topt.adamw_init(params)
    losses = []
    for s in range(45):
        batch = {k: torch.from_numpy(v) for k, v in ds.batch(s).items()}
        params, state, met = step(params, state, batch)
        losses.append(float(met["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.25, losses[::10]


def test_serving_after_a_step_sees_the_new_parameters(tiny_cfg):
    """The step updates the model's own parameters in place and drops its
    bf16 serving copies: forward_logits afterwards equals a model built from
    the updated parameters, and differs from before the step."""
    cfg = port_config(tiny_cfg)
    model = Model(cfg, tcfg.ParallelConfig(remat="none"), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12),
                                                              dtype=np.int32))
    before = model.forward_logits({"tokens": toks})
    params = model.params_tree()
    rng = np.random.default_rng(2)
    batch = {k: torch.from_numpy(x) for k, x in _batch(rng, cfg.vocab_size).items()}
    tc = tcfg.TrainConfig(**dict(TRAIN, learning_rate=1e-2))
    make_train_step(model, tc)(params, topt.adamw_init(params), batch)
    after = model.forward_logits({"tokens": toks})
    fresh = Model(cfg, device="cpu", seed=9)
    fresh.load_params(model.params_tree())
    assert torch.equal(after, fresh.forward_logits({"tokens": toks}))
    assert not torch.equal(after, before)
