"""The port's MLA (multi-head latent attention, DeepSeek-v2) against the JAX
package's, and the flash-attention plain version at MLA's head dims against
the Pallas kernel in interpret mode, on the same numpy inputs.

MLA runs flash attention at head dim qk_nope + qk_rope (192 for
deepseek-v2-lite-16b, 24 for the small configs here) with v zero-padded to
it. fp32 throughout: the two sides differ by summation order only."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import AttentionConfig as JaxAttention
from repro.kernels import runtime
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import attention as jattn
from repro_torch import config as tcfg
from repro_torch.kernels import flash_attention
from repro_torch.models import attention as tattn

# tests/test_serve.py's test_decode_parity_mla attention, d_model 64
MLA = JaxAttention(kind="mla", num_heads=4, num_kv_heads=4, kv_lora_rank=32,
                   qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
D_MODEL = 64


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("D,Dv,B,Sq,Skv,H", [
    (192, 128, 2, 40, 72, 4),     # deepseek-v2's 128 + 64, v padded from 128
    (24, 16, 2, 33, 50, 4),       # the smoke configs' 16 + 8, v padded from 16
])
@pytest.mark.parametrize("padded", [False, True])
def test_flash_plain_matches_pallas_at_mla_head_dims(D, Dv, B, Sq, Skv, H, padded):
    """Causal, H = KV as MLA has it, v's last D - Dv columns zero; with
    ``padded``, empty slots (position -1) and rows that see nothing."""
    rng = np.random.default_rng(D + Sq)
    q, k, v = (rng.standard_normal((B, S, H, D), dtype=np.float32)
               for S in (Sq, Skv, Skv))
    v[..., Dv:] = 0.0
    qp = np.tile(np.arange(Skv - Sq, Skv, dtype=np.int32), (B, 1))
    kp = np.tile(np.arange(Skv, dtype=np.int32), (B, 1))
    if padded:
        kp = kp + 10
        kp[:, -12:] = -1
        qp = qp - (Skv - Sq) - 5
    want = jax_flash(*(jnp.asarray(a) for a in (q, k, v, qp, kp)), block_q=32,
                     block_kv=32, interpret=True)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v, qp, kp)))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    assert np.all(_np(got)[..., Dv:] == 0.0)
    if padded:
        assert np.all(_np(got)[:, :15] == 0.0)       # q_pos < 10 sees no slot


def _port(cfg: JaxAttention) -> tcfg.AttentionConfig:
    return tcfg.AttentionConfig(**dataclasses.asdict(cfg))


def _params(cfg, seed: int = 0, norms_ones: bool = True) -> dict:
    """Seeded numpy weights shaped by the spec tree, at each spec's scale;
    the norm scales ones (their init) or 1 + 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in tattn.attn_specs(_port(cfg), D_MODEL).items():
        if s.init == "ones":
            out[name] = (np.ones(s.shape) if norms_ones
                         else 1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        else:
            out[name] = (rng.standard_normal(s.shape) * s.stddev).astype(np.float32)
    return out


MLA_CFGS = {"mla": MLA, "mla_q_lora": dataclasses.replace(MLA, q_lora_rank=24)}


def test_mla_specs_match_jax():
    for cfg in MLA_CFGS.values():
        theirs = jattn.attn_specs(cfg, D_MODEL)
        ours = tattn.attn_specs(_port(cfg), D_MODEL)
        assert {k: (s.shape, s.init, s.stddev) for k, s in ours.items()} == \
            {k: (s.shape, s.init, s.stddev) for k, s in theirs.items()}


@pytest.mark.parametrize("which", list(MLA_CFGS))
def test_mla_forward_prefill_cache_and_decode_match_jax(which):
    """``mla_forward`` (flash at head dim 24 through Pallas in interpret mode
    on the JAX side), ``mla_prefill_cache`` of a 10-token prompt into 16
    slots, then ``mla_decode`` for 6 steps from that cache (absorbed
    weights): outputs and caches within 1e-4; and each decode output equals
    the full forward's at its position within 1e-4."""
    cfg = MLA_CFGS[which]
    tcf = _port(cfg)
    p = _params(cfg, seed=1, norms_ones=False)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    B, S, k, L = 2, 16, 10, 16
    x = np.random.default_rng(2).standard_normal((B, S, D_MODEL)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    with runtime.pallas_enabled(interpret=True):
        jy = jax.jit(lambda p_, x_: jattn.mla_forward(p_, cfg, x_, jnp.asarray(pos),
                                                      dtype=jnp.float32))(jp, jnp.asarray(x))
    ty = tattn.mla_forward(tp, tcf, torch.from_numpy(x), torch.from_numpy(pos),
                           dtype=torch.float32)
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=1e-4, atol=1e-4)

    jc = jattn.mla_prefill_cache(jp, cfg, jnp.asarray(x[:, :k]), jnp.asarray(pos[:k]), L,
                                 jnp.float32)
    tc = tattn.mla_prefill_cache(tp, tcf, torch.from_numpy(x[:, :k]),
                                 torch.from_numpy(pos[:k]), L, torch.float32)
    for name in ("ckv", "k_rope", "pos"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), rtol=1e-4, atol=1e-4)
    assert _np(tc["pos"])[0].tolist() == list(range(k)) + [-1] * (L - k)
    for t in range(k, S):
        jo, jc = jattn.mla_decode(jp, cfg, jnp.asarray(x[:, t:t + 1]), jc, jnp.int32(t),
                                  dtype=jnp.float32)
        to, tc = tattn.mla_decode(tp, tcf, torch.from_numpy(x[:, t:t + 1]), tc, t,
                                  dtype=torch.float32)
        np.testing.assert_allclose(_np(to), _np(jo), rtol=1e-4, atol=1e-4,
                                   err_msg=f"step {t}")
        np.testing.assert_allclose(_np(to)[:, 0], _np(ty)[:, t], rtol=1e-4, atol=1e-4)
    for name in ("ckv", "k_rope", "pos"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), rtol=1e-4, atol=1e-4)


def test_head_dim_192_gradient_raises_before_any_launch(monkeypatch):
    """The backward kernel has no head dim 192 (ROADMAP Queue 2 item A): off
    the CPU (meta tensors stand in for the card's) the autograd path raises
    before its forward reaches the kernel, and so does the backward entry;
    without a gradient head dim 192 reaches the forward."""
    from repro_torch.kernels.flash_attention import kernel, ops
    launched = []
    monkeypatch.setattr(kernel, "flash_attention_cuda", lambda *a, **k: launched.append(a))
    monkeypatch.setattr(kernel, "flash_attention_bwd_cuda", lambda *a, **k: launched.append(a))
    assert 192 in ops.HEAD_DIMS and 192 not in ops.BWD_HEAD_DIMS
    q = torch.zeros((1, 4, 2, 192), device="meta", requires_grad=True)
    pos = torch.arange(4, device="meta")
    lse = torch.zeros((1, 2, 4), device="meta")
    counts = (ops.flash_attention.launches, ops.flash_attention.lse_launches,
              ops.flash_attention_bwd.launches)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 2 item A"):
        ops.flash_attention(q, q, q, pos, pos)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 2 item A"):
        ops.flash_attention_bwd(q, q, q, q, lse, q, pos, pos)
    assert not launched
    assert (ops.flash_attention.launches, ops.flash_attention.lse_launches,
            ops.flash_attention_bwd.launches) == counts
    with torch.no_grad():
        with pytest.raises(ValueError, match="unsupported device"):
            ops.flash_attention(*[torch.zeros((1, 4, 2, 192), device="meta")] * 3, pos, pos)
