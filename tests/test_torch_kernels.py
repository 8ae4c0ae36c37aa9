"""The port's kernel wrappers and layers on the CPU (where the wrappers use
their plain versions) against the JAX package: its Pallas kernels in
interpret mode and its plain layer functions, on the same numpy inputs.
Gradients are held against ``jax.grad`` of the JAX package's jnp oracles
(``flash_attention_jnp``, ``layers.rmsnorm``): its Pallas kernels have no
VJP."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro.kernels.rmsnorm import rmsnorm_ref as jax_rmsnorm_ref
from repro.models import layers as JL
from repro.models.attention import flash_attention_jnp
from repro_torch.kernels import flash_attention, rmsnorm
from repro_torch.kernels.flash_attention import flash_attention_bwd_ref, flash_attention_ref
from repro_torch.models import layers as TL

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(a: np.ndarray, dtype: str = "float32"):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
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


def _attn_case(B, Sq, Skv, H, KV, D, masked, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(s, dtype=np.float32) for s in
                   [(B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D), (B, Sq, H, D)])
    off = max(Skv - Sq, 0)
    qp = np.tile(np.arange(off, off + Sq, dtype=np.int32), (B, 1))
    kp = np.tile(np.arange(Skv, dtype=np.int32), (B, 1))
    if masked:   # per-batch positions, empty slots, rows that see nothing
        kp = kp + 10 + 3 * np.arange(B, dtype=np.int32)[:, None]
        kp[:, -5:] = -1
        qp = np.tile(2 * np.arange(Sq, dtype=np.int32) + 4, (B, 1))   # rows 0-2: < 10
    return q, k, v, do, qp, kp


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,causal,window,softcap,masked", [
    (2, 24, 24, 4, 2, 16, True, 0, 0.0, False),     # GQA, causal
    (1, 20, 20, 3, 3, 8, True, 6, 0.0, False),      # sliding window
    (2, 16, 16, 4, 1, 16, True, 0, 20.0, False),    # soft-cap, MQA
    (2, 12, 30, 4, 2, 16, True, 0, 0.0, True),      # ragged, per-batch positions
    (1, 18, 26, 2, 1, 8, False, 0, 0.0, False),     # not causal
])
def test_flash_attention_grad_matches_jax(B, Sq, Skv, H, KV, D, causal, window, softcap,
                                          masked):
    """The wrapper's autograd.Function on CPU tensors (plain forward with
    LSE, plain backward) against jax.grad of flash_attention_jnp: output and
    dq, dk, dv in fp32 to 1e-5."""
    q, k, v, do, qp, kp = _attn_case(B, Sq, Skv, H, KV, D, masked, Sq * Skv + H)
    kw = dict(causal=causal, window=window, softcap=softcap)

    def f(q_, k_, v_):
        out = flash_attention_jnp(q_, k_, v_, q_positions=jnp.asarray(qp),
                                  kv_positions=jnp.asarray(kp), block_kv=8, **kw)
        return jnp.sum(out * jnp.asarray(do)), out
    (_, want), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = flash_attention(tq, tk, tv, torch.from_numpy(qp), torch.from_numpy(kp), **kw)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(_np(out), _np(want), rtol=1e-5, atol=1e-5)
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), grads, "qkv"):
        np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-5, atol=1e-5,
                                   err_msg=f"d{name}")
    if masked:      # q_pos < 10 sees no slot: output 0 and dq 0
        assert np.all(_np(out)[:, :3] == 0.0) and np.all(_np(tq.grad)[:, :3] == 0.0)
        assert np.all(_np(out)[:, 5:] != 0.0)


def test_flash_attention_lse_and_no_grad_path():
    """Under no_grad the wrapper runs the plain forward alone (no autograd
    node); the LSE the training forward keeps is the log-sum-exp of the
    visible scores, +inf where a row sees nothing; a delta of 0 (one term
    of the gradient dropped) moves dq."""
    q, k, v, do, qp, kp = _attn_case(2, 12, 30, 4, 2, 16, True, 5)
    args = [torch.from_numpy(a) for a in (q, k, v, qp, kp)]
    with torch.no_grad():
        plain = flash_attention(*args)
    assert plain.grad_fn is None
    out, lse = flash_attention_ref(*args, return_lse=True)
    np.testing.assert_array_equal(_np(out), _np(plain))
    assert lse.shape == (2, 4, 12) and lse.dtype == torch.float32
    assert torch.isinf(lse[:, :, :3]).all() and (lse[:, :, :3] > 0).all()   # q_pos < 10
    s = np.einsum("bqkgd,bskd->bkgqs", q.reshape(2, 12, 2, 2, 16), k) * 16 ** -0.5
    ok = (kp[:, None, None, None, :] >= 0) & (kp[:, None, None, None, :]
                                              <= qp[:, None, None, :, None])
    with np.errstate(divide="ignore"):
        ref = np.log(np.where(ok, np.exp(s), 0.0).sum(-1)).reshape(2, 4, 12)
    live = np.isfinite(ref)
    assert live[:, :, 5:].all()
    np.testing.assert_allclose(_np(lse)[live], ref[live], rtol=1e-5)
    grads = flash_attention_bwd_ref(*args[:3], out, lse, torch.from_numpy(do), *args[3:])
    dropped = flash_attention_bwd_ref(*args[:3], out, lse, torch.from_numpy(do), *args[3:],
                                      delta=torch.zeros_like(lse))
    assert (grads[0] - dropped[0]).abs().max() > 1e-2


@pytest.mark.parametrize("shape", [(4, 17, 96), (2, 100), (3, 5, 7, 32)])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_rmsnorm_grad_matches_jax(shape, dtype, tol):
    """The wrapper's autograd.Function on CPU tensors (plain backward)
    against jax.grad of layers.rmsnorm: dx (in x's dtype) and dscale (fp32)
    in fp32 to 1e-5; in bf16, where both round the same fp32 dx, to 2e-2."""
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape, dtype=np.float32)
    s = rng.standard_normal(shape[-1:], dtype=np.float32)
    dy = rng.standard_normal(shape, dtype=np.float32)
    jx, tx = _both(x, dtype)
    jdy, tdy = _both(dy, dtype)

    def f(x_, s_):
        return jnp.sum((JL.rmsnorm({"scale": s_}, x_) * jdy).astype(jnp.float32))
    gx, gs = jax.grad(f, argnums=(0, 1))(jx, jnp.asarray(s))
    tx.requires_grad_(True)
    ts = torch.from_numpy(s).requires_grad_(True)
    out = rmsnorm(tx, ts)
    assert type(out.grad_fn).__name__ == "_RMSNormBackward"
    out.backward(tdy)
    assert tx.grad.dtype == tx.dtype and ts.grad.dtype == torch.float32
    np.testing.assert_allclose(_np(tx.grad), _np(gx), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(ts.grad), _np(gs), rtol=max(tol, 1e-5) if dtype ==
                               "float32" else 2e-2, atol=tol * np.abs(_np(gs)).max())


def test_library_name_follows_headers(tmp_path, monkeypatch):
    """A kernel's library is named by the hash of its source and of the
    headers beside it: an edited header gives a new library (no nvcc)."""
    from repro_torch.kernels import build
    src, header = tmp_path / "k.cu", tmp_path / "k.cuh"
    src.write_text('#include "k.cuh"\n')
    header.write_text("#define N 1\n")
    monkeypatch.setattr(build, "SOURCES", {"k": src})
    before = build.library("k")
    assert build.library("k") == before
    header.write_text("#define N 2\n")
    after = build.library("k")
    assert after != before and after.parent == before.parent
    (tmp_path / "other.cuh").write_text("// a new header beside the source\n")
    assert build.library("k") != after


@pytest.mark.filterwarnings("ignore:Mismatch dtype")   # no fused kernel for mixed dtypes
@pytest.mark.parametrize("shape", [(4, 17, 96), (2, 100), (3, 5, 7, 32)])
def test_torch_rms_norm_matches_plain_versions(shape):
    """F.rms_norm, the library call chip_smoke.py times beside the Triton
    kernels, on bf16 rows with an fp32 scale: the same bits as rmsnorm_ref,
    and its autograd gradients (bf16 dx, fp32 dscale) as rmsnorm_bwd_ref
    within the bf16 tolerances of test_rmsnorm_grad_matches_jax."""
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_ref, rmsnorm_ref
    rng = np.random.default_rng(sum(shape) + 1)
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(torch.bfloat16)
    s = torch.from_numpy(0.5 + 0.05 * rng.standard_normal(shape[-1:], dtype=np.float32))
    dy = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(torch.bfloat16)
    xr, sr = x.clone().requires_grad_(True), s.clone().requires_grad_(True)
    y = torch.nn.functional.rms_norm(xr, shape[-1:], sr, 1e-5)
    assert y.dtype == torch.bfloat16 and torch.equal(y, rmsnorm_ref(x, s, 1e-5))
    dx, ds = torch.autograd.grad(y, (xr, sr), dy)
    rdx, rds = rmsnorm_bwd_ref(x, s, dy, 1e-5)
    assert dx.dtype == torch.bfloat16 and ds.dtype == torch.float32
    np.testing.assert_allclose(_np(dx), _np(rdx), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(ds), _np(rds), rtol=2e-2,
                               atol=2e-2 * np.abs(_np(rds)).max())


# ---------------------------------------------------------------------------
# the bf16 limit of chip_smoke.py's check_flash_bwd against the kernels' design
# ---------------------------------------------------------------------------

def _emulate_flash_bwd(q, k, v, out, lse, dout, qp, kp, *, causal, window, softcap,
                       with_delta=True):
    """The two bf16 backward kernels of flash_attention_bwd.cu, tile by tile
    in fp32: their tile sizes (dK/dV: kv tiles of 128 rows, q items of BQ =
    64 rows, 32 for D = 128, summed over the q tiles in order and, within
    one, the heads of the group in order; dQ: q tiles of 128 rows, kv tiles
    of 64 in order), P = 2^(s log2(e) scale - lse log2(e)) (or the soft-cap's
    form) and dS = P (dP - delta) (1 - tanh^2), each rounded to bf16 where
    the kernels round them (the A operands of dV += P^T dO, dK += dS^T Q, dQ
    += dS K), fp32 sums, results rounded to bf16 once. Tiles that no row
    sees add exact zeros, as the kernels' skipped tiles would."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G, scale, log2e = H // KV, D ** -0.5, float(np.log2(np.e))
    bq = 32 if D == 128 else 64
    f = lambda t: t.float()                                   # noqa: E731
    rnd = lambda t: t.to(torch.bfloat16).float()              # noqa: E731
    qpos, kpos = qp[:, :, None], kp[:, None, :]
    ok = kpos >= 0                                            # (B, Sq, Skv)
    if causal:
        ok = ok & (kpos <= qpos)
    if window > 0:
        ok = ok & (qpos - kpos < window)
    delta = (f(dout) * f(out)).sum(-1).permute(0, 2, 1)       # (B, H, Sq)
    if not with_delta:
        delta = torch.zeros_like(delta)
    lse2 = lse.float() * log2e

    def p_ds(s, dp, l2, dl, mask):
        if softcap > 0:
            th = torch.tanh(s * (scale / softcap))
            sv, dfac = th * (softcap * log2e), 1.0 - th * th
        else:
            sv, dfac = s * (scale * log2e), 1.0
        p = torch.where(mask, torch.exp2(sv - l2), 0.0)
        return p, p * (dp - dl) * dfac

    dq = torch.zeros(B, Sq, H, D)
    dk = torch.zeros(B, Skv, KV, D)
    dv = torch.zeros(B, Skv, KV, D)
    for b in range(B):
        for kvh in range(KV):
            for k0 in range(0, Skv, 128):
                K, V = f(k[b, k0:k0 + 128, kvh]), f(v[b, k0:k0 + 128, kvh])
                dK, dV = torch.zeros_like(K), torch.zeros_like(V)
                for q0 in range(0, Sq, bq):
                    for h in range(kvh * G, kvh * G + G):
                        Q, dO = f(q[b, q0:q0 + bq, h]), f(dout[b, q0:q0 + bq, h])
                        pt, dst = p_ds(K @ Q.T, V @ dO.T, lse2[b, h, q0:q0 + bq],
                                       delta[b, h, q0:q0 + bq],
                                       ok[b, q0:q0 + bq, k0:k0 + 128].T)
                        dV += rnd(pt) @ dO
                        dK += rnd(dst) @ Q
                dk[b, k0:k0 + 128, kvh], dv[b, k0:k0 + 128, kvh] = dK * scale, dV
        for h in range(H):
            for q0 in range(0, Sq, 128):
                Q, dO = f(q[b, q0:q0 + 128, h]), f(dout[b, q0:q0 + 128, h])
                dQ = torch.zeros_like(Q)
                for k0 in range(0, Skv, 64):
                    K, V = f(k[b, k0:k0 + 64, h // G]), f(v[b, k0:k0 + 64, h // G])
                    _, ds = p_ds(Q @ K.T, dO @ V.T, lse2[b, h, q0:q0 + 128, None],
                                 delta[b, h, q0:q0 + 128, None], ok[b, q0:q0 + 128, k0:k0 + 64])
                    dQ += rnd(ds) @ K
                dq[b, q0:q0 + 128, h] = dQ * scale
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def _bwd_magnitudes(q, k, v, out, lse, dout, qp, kp, *, causal, window, softcap):
    """A of check_flash_bwd's limit, as chip_smoke.py's _bwd_magnitudes
    computes it: per gradient element the sum of the magnitudes of its terms
    in fp32, with m = |dS| + 2**-8 P (|dP| + |delta|) in place of |dS|."""
    from repro_torch.kernels.flash_attention.ref import _scores
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    s, t, ok = _scores(q, k, qp, kp, causal, window, softcap)
    p = torch.where(ok, torch.exp(s - lse.float().reshape(B, KV, G, Sq)[..., None]), 0.0)
    do = dout.float().reshape(B, Sq, KV, G, D)
    delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1).reshape(B, KV, G, Sq)
    dp = torch.einsum("bqkgd,bskd->bkgqs", do, v.float())
    ds = p * (dp - delta[..., None])
    noise = p * (dp.abs() + delta.abs()[..., None])
    if t is not None:
        ds, noise = ds * (1.0 - t * t), noise * (1.0 - t * t)
    ds = ds.abs() + 2.0 ** -8 * noise
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float().abs()) * D ** -0.5
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds,
                      q.float().abs().reshape(B, Sq, KV, G, D)) * D ** -0.5
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, do.abs())
    return dq.reshape(B, Sq, H, D), dk, dv


def _worst(got, refs, limits) -> float:
    """max over the gradients of |got - ref| / limit (an exact match is 0)."""
    worst = 0.0
    for x, r, lim in zip(got, refs, limits):
        d = (x.float() - r.float()).abs()
        worst = max(worst, torch.where(d == 0, 0.0, d / lim).max().item())
    return worst


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,causal,window,softcap,masked", [
    (2, 24, 24, 4, 2, 16, True, 0, 0.0, False),     # GQA, causal
    (1, 20, 20, 3, 3, 8, True, 6, 0.0, False),      # sliding window
    (2, 16, 16, 4, 1, 16, True, 0, 20.0, False),    # soft-cap, MQA
    (2, 12, 30, 4, 2, 16, True, 0, 0.0, True),      # ragged, per-batch positions
    (1, 18, 26, 2, 1, 8, False, 0, 0.0, False),     # not causal
])
def test_flash_bwd_bf16_limit_admits_the_kernels_rounding(B, Sq, Skv, H, KV, D, causal,
                                                          window, softcap, masked):
    """check_flash_bwd's bf16 limit, |d| <= 2**-7 |ref| + 2**-8 A, holds for
    an emulation of the backward kernels that rounds P and dS to bf16 where
    they do; the same emulation without its delta term fails it."""
    q, k, v, do, qp, kp = _attn_case(B, Sq, Skv, H, KV, D, masked, Sq * Skv + H)
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do))
    qp, kp = torch.from_numpy(qp), torch.from_numpy(kp)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = flash_attention_ref(q, k, v, qp, kp, return_lse=True, **kw)
    refs = flash_attention_bwd_ref(q, k, v, out, lse, do, qp, kp, **kw)
    mags = _bwd_magnitudes(q, k, v, out, lse, do, qp, kp, **kw)
    limits = [2.0 ** -7 * r.float().abs() + 2.0 ** -8 * a for r, a in zip(refs, mags)]
    got = _emulate_flash_bwd(q, k, v, out, lse, do, qp, kp, **kw)
    assert all(x.dtype == torch.bfloat16 and x.shape == r.shape for x, r in zip(got, refs))
    assert _worst(got, refs, limits) <= 1.0
    dropped = _emulate_flash_bwd(q, k, v, out, lse, do, qp, kp, with_delta=False, **kw)
    assert _worst(dropped[:2], refs[:2], limits[:2]) > 1.0
