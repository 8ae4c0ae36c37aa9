"""The port's Model against the JAX package's, on the same weights (through
the bridge) and the same tokens: full forward, prefill and every decode
step, in fp32 to 1e-4 and in bf16 to 0.1; the greedy tokens and the loss
(MoE aux included) of the MoE and MLA configs. The JAX model runs unsharded
and through its Pallas flash and SSD kernels in interpret mode."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import AttentionConfig, ModelConfig, MoEConfig, ParallelConfig, SSMConfig
from repro.config import get_arch as jax_get_arch
from repro.config import get_smoke as jax_get_smoke
from repro.kernels import runtime
from repro.models import Model as JaxModel
from repro.serve import greedy_generate as jax_greedy_generate
from repro_torch import config as tcfg
from repro_torch.bridge import params_from_numpy
from repro_torch.models import Model
from repro_torch.models.model import model_specs
from repro_torch.models.spec import num_params
from repro_torch.serve import greedy_generate


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


# The five dense archs of the zoo, each on its smoke config, long enough to
# cross its windows: danube's smoke (window 64) prefills 70 tokens into its
# 64-slot ring and decodes to 80; gemma3's (local window 32, every 6th layer
# global) prefills 40 and decodes to 48.
DENSE_ZOO = {"h2o-danube-1.8b": dict(S=80, k=70), "internlm-7b": {},
             "gemma3-27b": dict(S=48, k=40), "nemotron-4-15b": {}, "internlm-123b": {}}


@pytest.mark.parametrize("arch", list(DENSE_ZOO))
def test_parity_dense_zoo_smoke(arch):
    """fp32, atol 1e-4, as test_parity_smollm_smoke."""
    _parity(_f32(jax_get_smoke(arch)), atol=1e-4, **DENSE_ZOO[arch])


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


def test_danube_params_tree_and_specs_match_jax():
    """Full size, specs only: 24 layers of 69.5 M, untied embedding and LM
    head of 81.9 M each."""
    assert _specs_match_jax("h2o-danube-1.8b") == 1_831_201_280


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
    (dict(family="audio", encoder_layers=2, encoder_seq=16), "item 11"),
    (dict(frontend="patch_stub", num_patches=4), "item 11"),
])
def test_unported_layers_name_their_roadmap_item(change, item):
    """What the port still lacks, the encoder-decoder and VLM frontends,
    raises naming its ROADMAP item."""
    cfg = dataclasses.replace(tcfg.get_smoke("smollm-360m"), **change)
    with pytest.raises(NotImplementedError, match=item):
        Model(cfg, device="cpu")


# ---------------------------------------------------------------------------
# MoE and MLA: deepseek-v2-lite-16b, mixtral-8x22b and jamba-1.5-large-398b
# ---------------------------------------------------------------------------

MLA_CFG = ModelConfig(      # tests/test_serve.py's test_decode_parity_mla config
    name="mla", num_layers=2, d_model=64, d_ff=128, vocab_size=256,
    max_seq_len=128, vocab_pad_multiple=64,
    attention=AttentionConfig(kind="mla", num_heads=4, num_kv_heads=4,
                              kv_lora_rank=32, qk_nope_dim=16,
                              qk_rope_dim=8, v_head_dim=16))

HYBRID_MOE_CFG = ModelConfig(   # tests/test_serve.py's test_decode_parity_hybrid_moe
    name="hy", family="hybrid", num_layers=4, d_model=64, d_ff=128,
    vocab_size=256, max_seq_len=128, vocab_pad_multiple=64,
    attn_every=4, attn_index=1,
    attention=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=16),
    ssm=SSMConfig(state_dim=16, head_dim=16, n_groups=1, chunk_size=8),
    moe=MoEConfig(num_experts=4, top_k=2, expert_ff=64, moe_every=2,
                  moe_offset=1))

# fp32 configs of the MoE/MLA parity: the three MoE archs' smoke configs
# (jamba's runs mamba, attention and MoE every other layer in one 8-layer
# pattern) and the two decode-parity configs of tests/test_serve.py
MOE_MLA = {
    "deepseek-v2-lite-16b": lambda: jax_get_smoke("deepseek-v2-lite-16b"),
    "mixtral-8x22b": lambda: jax_get_smoke("mixtral-8x22b"),
    "jamba-1.5-large-398b": lambda: jax_get_smoke("jamba-1.5-large-398b"),
    "mla": lambda: MLA_CFG,
    "hybrid-moe": lambda: HYBRID_MOE_CFG,
}
MOE_MLA_KW = {"mixtral-8x22b": dict(S=80, k=70),     # past the smoke's 64 window
              "jamba-1.5-large-398b": dict(S=40, k=33, self_atol=1e-3),
              "hybrid-moe": dict(self_atol=1e-3)}


@pytest.mark.parametrize("which", list(MOE_MLA))
def test_parity_moe_and_mla(which):
    """fp32 logits within 1e-4 through forward, prefill and every decode
    step (decode against the port's own forward within 1e-3 where mamba
    layers run their recurrence, as test_parity_ssm)."""
    _parity(_f32(MOE_MLA[which]()), atol=1e-4, **MOE_MLA_KW.get(which, {}))


@pytest.mark.parametrize("which", list(MOE_MLA))
def test_greedy_tokens_moe_and_mla_equal_jax(which):
    """fp32: a 12-token prompt, then 8 greedy tokens through prefill and
    decode, identical to the JAX package's ``greedy_generate``."""
    cfg = _f32(MOE_MLA[which]())
    jm, params, tm = both_models(cfg, seed=3)
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12), dtype=np.int32)
    with runtime.pallas_enabled(interpret=True):
        want = jax_greedy_generate(jm, params, jnp.asarray(prompt), 8)
    got = greedy_generate(tm, torch.from_numpy(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("which", list(MOE_MLA))
def test_loss_with_moe_aux_equals_jax(which):
    """``Model.loss`` and its metrics (xent, the MoE aux summed over the
    layers and scaled by router_aux_coef, tokens) equal the JAX package's
    within 1e-5 relative; aux is > 0 wherever there are MoE layers."""
    cfg = _f32(MOE_MLA[which]())
    jm, params, tm = both_models(cfg, seed=5)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 17), dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, jmet = jax.jit(jm.loss)(params, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tmet = tm.loss(tm.params_tree(), {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "xent", "aux", "tokens"):
        np.testing.assert_allclose(_np(tmet[k]), _np(jmet[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert (float(tmet["aux"]) > 0) == (cfg.moe.num_experts > 0)


def test_deepseek_params_tree_and_specs_match_jax():
    """Full size, specs only: 15.7 B parameters (MLA, 26 MoE layers of 64
    routed and 2 shared experts, the dense first layer)."""
    assert _specs_match_jax("deepseek-v2-lite-16b") == 15_706_484_224


def _mla_smoke(q_lora: bool):
    cfg = jax_get_smoke("deepseek-v2-lite-16b")
    if q_lora:
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(cfg.attention,
                                                                     q_lora_rank=24))
    return cfg


@pytest.mark.parametrize("q_lora", [False, True])
def test_compute_tree_keeps_mla_norm_scales_fp32(q_lora):
    """bf16 serving copies: every leaf the reference reads in fp32 (each
    ``scale``, MLA's ``kv_norm`` and, with a q LoRA, ``q_norm``) stays an
    fp32 tensor equal to its master; the projections are bf16."""
    tm = Model(port_config(_mla_smoke(q_lora)), device="cpu")
    masters = tm.params_tree()
    names = []
    for si, seg in enumerate(tm._compute["segments"]):
        for li, layer in enumerate(seg):
            attn = layer["attn"]
            for name in ("kv_norm", "q_norm"):
                if name in attn:
                    names.append(name)
                    assert attn[name].dtype == torch.float32, name
                    assert torch.equal(attn[name], masters["segments"][si][li]["attn"][name])
            for ln in ("ln1", "ln2"):
                assert layer[ln]["scale"].dtype == torch.float32
            assert attn["w_dkv"].dtype == attn["w_uk"].dtype == torch.bfloat16
    assert sorted(set(names)) == (["kv_norm", "q_norm"] if q_lora else ["kv_norm"])
    assert tm._compute["final_norm"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("q_lora", [False, True])
def test_bf16_parity_with_seeded_norm_scales(q_lora):
    """bf16 compute with ``kv_norm``, ``q_norm`` and every ``scale`` set to
    seeded values bf16 cannot hold (1 + 0.1 N(0, 1) in fp32): logits within
    0.1 of JAX's, the bf16 limit of test_parity_bf16_smollm_smoke. A norm
    scale cast to bf16 moves every logit downstream of it."""
    cfg = _mla_smoke(q_lora)
    jm = JaxModel(cfg, ParallelConfig(remat="none", moe_impl="dense"))
    params = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    changed = []

    def seeded(path, x):
        name = jax.tree_util.keystr(path)
        if name.endswith(("['scale']", "['kv_norm']", "['q_norm']")):
            changed.append(name)
            return jnp.asarray(1.0 + 0.1 * rng.standard_normal(x.shape), jnp.float32)
        return x
    params = jax.tree_util.tree_map_with_path(seeded, params)
    assert any("kv_norm" in n for n in changed)
    assert any("q_norm" in n for n in changed) == q_lora
    tm = Model(port_config(cfg), device="cpu")
    tm.load_params(params_from_numpy(jax.tree_util.tree_map(np.asarray, params)))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24), dtype=np.int32)
    with runtime.pallas_enabled(interpret=True):
        want = jax.jit(jm.forward_logits)(params, {"tokens": jnp.asarray(toks)})
    got = tm.forward_logits({"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got), _np(want), rtol=0.1, atol=0.1)


def test_init_caches_mla_shapes():
    cfg = tcfg.get_smoke("deepseek-v2-lite-16b")
    caches = Model(cfg, device="cpu").init_caches(batch=3, prompt_len=40)
    assert [len(seg) for seg in caches] == [1, 1]         # dense layer, then 2 MoE
    kv = caches[1][0]["kv"]
    a = cfg.attention
    assert kv["ckv"].shape == (2, 3, 40, a.kv_lora_rank)
    assert kv["k_rope"].shape == (2, 3, 40, a.qk_rope_dim)
    assert kv["ckv"].dtype == torch.bfloat16
    assert bool((kv["pos"] == -1).all())
