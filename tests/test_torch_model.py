"""The port's Model against the JAX package's, on the same weights (through
the bridge) and the same tokens: full forward, prefill and every decode
step, in fp32 to 1e-4 and in bf16 to 0.1. The JAX model runs unsharded and
through its Pallas flash and SSD kernels in interpret mode."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import AttentionConfig, ModelConfig, ParallelConfig, SSMConfig
from repro.config import get_arch as jax_get_arch
from repro.config import get_smoke as jax_get_smoke
from repro.kernels import runtime
from repro.models import Model as JaxModel
from repro_torch import config as tcfg
from repro_torch.bridge import params_from_numpy
from repro_torch.models import Model
from repro_torch.models.model import model_specs
from repro_torch.models.spec import num_params


def port_config(cfg) -> tcfg.ModelConfig:
    """The JAX package's ModelConfig rebuilt field for field in the port."""
    d = dataclasses.asdict(cfg)
    d["attention"] = tcfg.AttentionConfig(**d["attention"]) if d["attention"] else None
    d["moe"] = tcfg.MoEConfig(**d["moe"])
    d["ssm"] = tcfg.SSMConfig(**d["ssm"]) if d["ssm"] else None
    return tcfg.ModelConfig(**d)


def both_models(cfg, seed: int = 0):
    jm = JaxModel(cfg, ParallelConfig(remat="none", moe_impl="dense"))
    params = jm.init(jax.random.PRNGKey(seed))
    tm = Model(port_config(cfg), device="cpu")
    tm.load_params(params_from_numpy(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _parity(cfg, *, atol: float, S: int = 24, k: int = 16, B: int = 2,
            self_atol: float | None = None):
    """forward, prefill(prompt[:k]) and decode steps k..S-1 agree with the
    JAX package within ``atol``, and decode reproduces the port's own full
    forward within ``self_atol`` (default ``atol``)."""
    self_atol = atol if self_atol is None else self_atol
    jm, params, tm = both_models(cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    with runtime.pallas_enabled(interpret=True):   # read while tracing
        jfull = jax.jit(jm.forward_logits)(params, {"tokens": jt})
        jl, jc = jax.jit(jm.prefill)(params, {"tokens": jt[:, :k]})
    jstep = jax.jit(jm.decode_step)
    full = tm.forward_logits({"tokens": tt})
    assert full.shape == (B, S, cfg.padded_vocab)
    np.testing.assert_allclose(_np(full), _np(jfull), rtol=atol, atol=atol)
    tl, tc = tm.prefill({"tokens": tt[:, :k]})
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=atol, atol=atol)
    for t in range(k, S):
        jl, jc = jstep(params, jc, jt[:, t], jnp.int32(t))
        tl, tc = tm.decode_step(tc, tt[:, t], t)
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=atol, atol=atol,
                                   err_msg=f"{cfg.name}: decode step {t}")
        np.testing.assert_allclose(_np(tl), _np(full[:, t]), rtol=self_atol,
                                   atol=self_atol)
    return jc, tc


def _f32(cfg, **kw):
    return dataclasses.replace(cfg, dtype="float32", **kw)


def test_parity_tiny(tiny_cfg):
    _parity(_f32(tiny_cfg), atol=1e-4)


def test_parity_smollm_smoke():
    _parity(_f32(jax_get_smoke("smollm-360m")), atol=1e-4)


def test_parity_swa(tiny_cfg):
    cfg = _f32(tiny_cfg, name="swa", attention=dataclasses.replace(
        tiny_cfg.attention, sliding_window=8))
    _parity(cfg, atol=1e-4)


def test_parity_local_global(tiny_cfg):
    cfg = _f32(tiny_cfg, name="lg", num_layers=4, attention=dataclasses.replace(
        tiny_cfg.attention, global_every=2, local_window=8))
    _parity(cfg, atol=1e-4)


def test_ring_buffer_rolls_past_window(tiny_cfg):
    """A 13-token prompt into an 8-slot ring (roll by 13 % 8), then decoding
    to 3x the window: caches and logits equal the JAX package's."""
    cfg = _f32(tiny_cfg, name="roll", max_seq_len=8, attention=dataclasses.replace(
        tiny_cfg.attention, sliding_window=8))
    jc, tc = _parity(cfg, atol=1e-4, S=24, k=13, B=1)
    for n in ("k", "v", "pos"):
        np.testing.assert_allclose(_np(tc[0][0]["kv"][n]), _np(jc[0][0]["kv"][n]),
                                   rtol=1e-5, atol=1e-5)
    assert sorted(np.asarray(tc[0][0]["kv"]["pos"][0, 0]).tolist()) == list(range(16, 24))


def test_parity_bf16_smollm_smoke():
    """bf16 rounds at other places in the two frameworks: logits within 0.1."""
    _parity(jax_get_smoke("smollm-360m"), atol=0.1)


SSM_CFG = ModelConfig(      # tests/test_serve.py's ssm decode-parity config
    name="ssm", family="ssm", num_layers=2, d_model=64, d_ff=0,
    vocab_size=256, max_seq_len=128, vocab_pad_multiple=64,
    ssm=SSMConfig(state_dim=16, head_dim=16, n_groups=1, chunk_size=8))

HYBRID_CFG = ModelConfig(   # tests/test_serve.py's hybrid config, dense MLPs,
    name="hy", family="hybrid", num_layers=8, d_model=64, d_ff=128,  # 8 layers
    vocab_size=256, max_seq_len=128, vocab_pad_multiple=64,
    attn_every=4, attn_index=1,
    attention=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=16),
    ssm=SSMConfig(state_dim=16, head_dim=16, n_groups=1, chunk_size=8))


def test_parity_ssm():
    """Prefill spans two chunks and a ragged one; decode steps the state.
    Decode against the port's own full forward: within 1e-3, the tolerance
    of tests/test_serve.py's ssm decode parity (the recurrence and the
    chunked scan sum in other orders)."""
    _parity(_f32(SSM_CFG), atol=1e-4, S=24, k=19, self_atol=1e-3)


def test_parity_mamba2_smoke():
    _parity(_f32(jax_get_smoke("mamba2-1.3b")), atol=1e-4, S=48, k=40,
            self_atol=1e-3)


def test_parity_hybrid_attention_and_mamba():
    """8 layers make one segment of the pattern (mamba, attn, mamba, mamba)
    repeated twice: attention and mamba caches side by side in one stack."""
    jc, tc = _parity(_f32(HYBRID_CFG), atol=1e-4, self_atol=1e-3)
    assert len(tc) == 1
    assert [sorted(c) for c in tc[0]] == [["ssm"], ["kv"], ["ssm"], ["ssm"]]
    assert tc[0][1]["kv"]["k"].shape[0] == tc[0][0]["ssm"]["ssm"].shape[0] == 2


def test_parity_bf16_mamba2_smoke():
    """bf16: logits within 0.1. With A_log or dt_bias cast to bf16 (or the
    gated-norm scale), every number moves and this fails."""
    _parity(jax_get_smoke("mamba2-1.3b"), atol=0.1, S=48, k=40)


def _specs_match_jax(arch: str) -> int:
    """The port's spec tree has the JAX package's paths and shapes; returns
    its parameter count."""
    cfg = jax_get_arch(arch)
    jspecs = JaxModel(cfg, ParallelConfig(remat="none")).specs()
    tspecs = model_specs(port_config(cfg))
    jflat = {jax.tree_util.keystr(p): s.shape for p, s in
             jax.tree_util.tree_flatten_with_path(
                 jspecs, is_leaf=lambda x: hasattr(x, "stddev"))[0]}
    tflat = {}

    def walk(t, path=""):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}[{k!r}]")
        elif isinstance(t, (list, tuple)) and not hasattr(t, "stddev"):
            for i, v in enumerate(t):
                walk(v, f"{path}[{i}]")
        else:
            tflat[path] = t.shape
    walk(tspecs)
    assert tflat == jflat
    return num_params(tspecs)


def test_params_tree_and_specs_match_jax():
    assert _specs_match_jax("smollm-360m") == 361_821_120


def test_mamba_params_tree_and_specs_match_jax():
    assert _specs_match_jax("mamba2-1.3b") == 1_343_790_080


def test_init_is_deterministic_per_seed():
    cfg = tcfg.get_smoke("smollm-360m")
    a = Model(cfg, device="cpu", seed=0).params_tree()
    b = Model(cfg, device="cpu", seed=0).params_tree()
    c = Model(cfg, device="cpu", seed=1).params_tree()
    assert torch.equal(a["embed"]["tok"], b["embed"]["tok"])
    assert not torch.equal(a["embed"]["tok"], c["embed"]["tok"])
    assert torch.equal(a["final_norm"]["scale"], torch.ones(cfg.d_model))
    w = a["segments"][0][0]["mlp"]["w2"]
    assert abs(w.std().item() - cfg.d_ff ** -0.5) < 0.1 * cfg.d_ff ** -0.5


def test_compute_weights_cast_once_norm_scales_stay_fp32():
    m = Model(tcfg.get_smoke("smollm-360m"), device="cpu")
    assert m._compute["embed"]["tok"].dtype == torch.bfloat16
    assert m._compute["segments"][0][0]["attn"]["wq"].dtype == torch.bfloat16
    assert m._compute["segments"][0][0]["ln1"]["scale"].dtype == torch.float32
    assert m.params["embed"]["tok"].dtype == torch.float32
    mamba = Model(tcfg.get_smoke("mamba2-1.3b"), device="cpu")._compute
    layer = mamba["segments"][0][0]["mamba"]
    for name in ("norm", "A_log", "dt_bias"):
        assert layer[name].dtype == torch.float32, name
    for name in ("D", "in_x", "conv_x", "conv_x_b", "out"):
        assert layer[name].dtype == torch.bfloat16, name


def test_init_caches_shapes():
    cfg = tcfg.get_smoke("smollm-360m")
    caches = Model(cfg, device="cpu").init_caches(batch=3, prompt_len=40)
    kv = caches[0][0]["kv"]
    assert kv["k"].shape == (cfg.num_layers, 3, 40, 2, 20)
    assert bool((kv["pos"] == -1).all())
    cfg = tcfg.get_smoke("mamba2-1.3b")
    ssm = Model(cfg, device="cpu").init_caches(batch=3, prompt_len=40)[0][0]["ssm"]
    assert ssm["ssm"].shape == (cfg.num_layers, 3, 12, 16, 16)
    assert ssm["ssm"].dtype == torch.float32
    assert ssm["conv_x"].shape == (cfg.num_layers, 3, 3, 192)
    assert ssm["conv_B"].shape == ssm["conv_C"].shape == (cfg.num_layers, 3, 3, 16)
    assert ssm["conv_x"].dtype == torch.bfloat16


def test_model_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the check is for machines without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(tcfg.get_smoke("smollm-360m"))


@pytest.mark.parametrize("change,item", [
    (dict(moe=tcfg.MoEConfig(num_experts=4, expert_ff=32)), "item 9"),
    (dict(attention=tcfg.AttentionConfig(kind="mla", kv_lora_rank=16)), "item 10"),
])
def test_unported_layers_name_their_roadmap_item(change, item):
    cfg = dataclasses.replace(tcfg.get_smoke("smollm-360m"), **change)
    with pytest.raises(NotImplementedError, match=item):
        Model(cfg, device="cpu")
