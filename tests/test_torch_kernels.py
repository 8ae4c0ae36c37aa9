"""The port's kernel wrappers and layers on the CPU (where the wrappers use
their plain versions) against the JAX package: its Pallas kernels in
interpret mode and its plain layer functions, on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro.kernels.rmsnorm import rmsnorm_ref as jax_rmsnorm_ref
from repro.models import layers as JL
from repro_torch.kernels import flash_attention, rmsnorm
from repro_torch.models import layers as TL

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(a: np.ndarray, dtype: str = "float32"):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D", [
    (2, 64, 64, 4, 2, 32),
    (1, 96, 96, 8, 8, 16),
    (2, 33, 128, 4, 1, 64),     # ragged Sq, MQA
    (1, 128, 48, 6, 3, 24),     # ragged Skv
])
@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (True, 24, 0.0), (False, 0, 0.0), (True, 0, 30.0),
])
def test_flash_attention_matches_pallas(B, Sq, Skv, H, KV, D, causal, window,
                                        softcap):
    rng = np.random.default_rng(B * 1000 + Sq + Skv)
    q, k, v = (rng.standard_normal(s, dtype=np.float32)
               for s in [(B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D)])
    off = max(Skv - Sq, 0)
    qp = np.arange(off, off + Sq, dtype=np.int32)
    kp = np.arange(Skv, dtype=np.int32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = jax_flash(*(jnp.asarray(a) for a in (q, k, v, qp, kp)),
                     block_q=32, block_kv=32, **kw)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v, qp, kp)), **kw)
    np.testing.assert_allclose(_np(got), _np(want), rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 3e-5), ("bfloat16", 3e-2)])
def test_flash_attention_dtypes(dtype, tol):
    rng = np.random.default_rng(7)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in [(1, 64, 4, 32), (1, 64, 2, 32), (1, 64, 2, 32)]]
    pos = np.arange(64, dtype=np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in arrs)
    want = jax_flash(jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos),
                     block_q=32, block_kv=32)
    got = flash_attention(tq, tk, tv, torch.from_numpy(pos), torch.from_numpy(pos))
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_flash_attention_empty_slots_and_masked_rows():
    """Slots at position -1 are never seen; a row that sees nothing is 0."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(s, dtype=np.float32)
               for s in [(2, 40, 4, 32), (2, 72, 2, 32), (2, 72, 2, 32)])
    kp = np.tile(np.arange(10, 82, dtype=np.int32), (2, 1))
    kp[:, -20:] = -1
    qp = np.tile(np.arange(40, dtype=np.int32) - 5, (2, 1))
    want = jax_flash(*(jnp.asarray(a) for a in (q, k, v, qp, kp)),
                     block_q=32, block_kv=32)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v, qp, kp)))
    np.testing.assert_allclose(_np(got), _np(want), rtol=3e-5, atol=3e-5)
    assert np.all(_np(got)[:, :15] == 0.0)      # q_pos < 10 sees no slot


def test_wrappers_reject_devices_without_a_kernel():
    """No fallback: a tensor that is neither on the CPU nor on the card
    raises instead of reaching the plain version."""
    q = torch.zeros((1, 4, 2, 64), device="meta")
    pos = torch.arange(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, q, q, pos, pos)
    with pytest.raises(ValueError, match="unsupported device"):
        rmsnorm(torch.zeros((3, 8), device="meta"), torch.ones(8, device="meta"))


@pytest.mark.parametrize("shape", [(4, 17, 96), (2, 100), (3, 5, 7, 32)])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_rmsnorm_matches_pallas_and_layer(shape, dtype, tol):
    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape, dtype=np.float32)
    s = rng.standard_normal(shape[-1:], dtype=np.float32)
    jx, tx = _both(x, dtype)
    js, ts = jnp.asarray(s), torch.from_numpy(s)
    got = rmsnorm(tx, ts)
    assert got.dtype == DTYPES[dtype][1] and got.shape == tx.shape
    for want in (jax_rmsnorm(jx, js), jax_rmsnorm_ref(jx, js),
                 JL.rmsnorm({"scale": js}, jx)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    np.testing.assert_array_equal(_np(TL.rmsnorm({"scale": ts}, tx)), _np(got))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_matches(dtype):
    rng = np.random.default_rng(11)
    w = rng.standard_normal((128, 960), dtype=np.float32) * 0.03
    tok = rng.integers(0, 128, (2, 9), dtype=np.int32)
    jd, td = DTYPES[dtype]
    want = JL.embed({"tok": jnp.asarray(w)}, jnp.asarray(tok), jd, 960)
    got = TL.embed({"tok": torch.from_numpy(w)}, torch.from_numpy(tok), td, 960)
    assert got.dtype == td
    # sqrt(960) is taken in the compute dtype: 31.0 in bf16, so the two
    # agree to the bit there; in fp32 up to the last ulp of the sqrt
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("pos_shape", ["shared", "per_batch"])
def test_apply_rope_matches(pos_shape):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 13, 3, 16), dtype=np.float32)
    pos = np.arange(290, 303, dtype=np.int32)
    if pos_shape == "per_batch":
        pos = np.stack([pos, pos[::-1]])
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(TL.rope_freqs(16, 10000.0).numpy(),
                               np.asarray(JL.rope_freqs(16, 10000.0)), rtol=1e-6)


@pytest.mark.parametrize("act", ["silu_glu", "gelu_glu", "relu2", "gelu"])
def test_mlp_matches(act):
    rng = np.random.default_rng(9)
    spec = JL.mlp_specs(48, 80, act)
    p = {n: rng.standard_normal(s.shape, dtype=np.float32) * s.stddev
         for n, s in spec.items()}
    x = rng.standard_normal((2, 5, 48), dtype=np.float32)
    want = JL.mlp({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x), act,
                  jnp.float32)
    got = TL.mlp({n: torch.from_numpy(a) for n, a in p.items()},
                 torch.from_numpy(x), act, torch.float32)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    assert set(TL.mlp_specs(48, 80, act)) == set(spec)
