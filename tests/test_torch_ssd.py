"""The port's SSD scan and Mamba2 block on the CPU (where the SSD wrapper uses
its plain version) against the JAX package: its Pallas SSD kernel in
interpret mode, its jnp oracle and its mamba functions, on the same numpy
inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SSMConfig as JaxSSMConfig
from repro.kernels import runtime
from repro.kernels.ssd import ssd as jax_ssd
from repro.models import mamba as JM
from repro_torch.config import SSMConfig
from repro_torch.kernels import ssd, ssd_ref
from repro_torch.models import mamba as TM

TOL = 3e-4      # as tests/test_kernels.py holds the Pallas kernel to its oracle


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _inputs(seed, B, L, H, P, G, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P), dtype=np.float32)
    dt = np.logaddexp(rng.standard_normal((B, L, H)), 0).astype(np.float32)
    A = -np.exp(0.5 * rng.standard_normal(H)).astype(np.float32)
    Bm = 0.5 * rng.standard_normal((B, L, G, N), dtype=np.float32)
    Cm = 0.5 * rng.standard_normal((B, L, G, N), dtype=np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("B,L,H,P,G,N,chunk", [
    (2, 64, 4, 16, 2, 32, 16),
    (1, 100, 2, 8, 1, 16, 32),      # ragged L
    (2, 128, 8, 32, 8, 64, 64),     # G == H
    (1, 200, 2, 64, 1, 128, 64),    # the full configs' (P, N), ragged
])
def test_ssd_matches_pallas(B, L, H, P, G, N, chunk):
    arrs = _inputs(L + H, B, L, H, P, G, N)
    want_y, want_s = jax_ssd(*(jnp.asarray(a) for a in arrs), chunk=chunk)
    got_y, got_s = ssd(*(torch.from_numpy(a) for a in arrs), chunk=chunk)
    assert got_y.shape == (B, L, H, P) and got_s.shape == (B, H, P, N)
    np.testing.assert_allclose(_np(got_y), _np(want_y), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(got_s), _np(want_s), rtol=TOL, atol=TOL)


def test_ssd_ref_initial_state_matches_ssd_chunked():
    arrs = _inputs(5, 2, 40, 4, 16, 2, 32)
    init = np.random.default_rng(6).standard_normal((2, 4, 16, 32), dtype=np.float32)
    want_y, want_s = JM.ssd_chunked(*(jnp.asarray(a) for a in arrs), chunk=16,
                                    initial_state=jnp.asarray(init),
                                    return_final_state=True)
    got_y, got_s = ssd_ref(*(torch.from_numpy(a) for a in arrs), chunk=16,
                           initial_state=torch.from_numpy(init))
    np.testing.assert_allclose(_np(got_y), _np(want_y), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(got_s), _np(want_s), rtol=TOL, atol=TOL)


def test_ssd_bf16_output_dtype_and_fp32_state():
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in _inputs(7, 1, 24, 2, 16, 1, 16))
    y, s = ssd(x.bfloat16(), dt, A, Bm.bfloat16(), Cm.bfloat16(), chunk=8)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    y32, s32 = ssd(x.bfloat16().float(), dt, A, Bm.bfloat16().float(),
                   Cm.bfloat16().float(), chunk=8)
    assert torch.equal(y, y32.bfloat16()) and torch.equal(s, s32)


def test_ssd_wrapper_rejects_devices_without_a_kernel():
    x = torch.zeros((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ssd(x, torch.zeros((1, 8, 2), device="meta"), torch.zeros(2, device="meta"),
            torch.zeros((1, 8, 1, 16), device="meta"),
            torch.zeros((1, 8, 1, 16), device="meta"), chunk=8)


# ---------------------------------------------------------------------------
# the CUDA kernel's bf16 arithmetic, rehearsed on the CPU
# ---------------------------------------------------------------------------
#
# The bf16 kernel runs the passes of ssd_ref (C·Bᵀ per group, chunk states,
# the state recurrence, the chunk scan) on the tensor cores: each product of
# two bf16 values is exact in fp32 and sums are fp32, and the three products
# with an fp32 operand (W x, (w∘x)ᵀ B, C R) split that operand into bf16
# parts. This emulates it in torch (fp32 matmuls of bf16-valued tensors) and
# holds it to check_ssd's per-element limits in chip_smoke.py.

def _split(v: torch.Tensor, parts: int) -> list:
    """v as ``parts`` bf16 values (hi, mid, lo, ...), each of what is left."""
    out = []
    for _ in range(parts):
        p = v.to(torch.bfloat16).float()
        out.append(p)
        v = v - p
    return out


def _mm_split(a, b, parts, *, split_a=True):
    """a @ b, the fp32 operand cut into bf16 parts, smallest part first."""
    if split_a:
        return sum(p @ b for p in reversed(_split(a, parts)))
    return sum(a @ p for p in reversed(_split(b, parts)))


def _four_pass(x, dt, A, Bm, Cm, chunk, parts):
    """The kernel's passes in fp32 with bf16 products; y in fp32."""
    from repro_torch.kernels.ssd.ref import chunk_cumsum
    b, L, H, P = x.shape
    G, N = Bm.shape[-2:]
    rep, cl = H // G, min(chunk, L)
    nc = -(-L // cl)
    pad = nc * cl - L

    def rows(t, width):                     # pad L with zero rows, cut into chunks
        t = torch.nn.functional.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(b, nc, cl, *width)
    xc, dtc = rows(x, (H, P)), rows(dt, (H,))
    Bc, Cc = rows(Bm, (G, N)), rows(Cm, (G, N))
    cum = chunk_cumsum(dtc * A.float(), dim=2)                       # (b, nc, cl, H)
    CB = torch.einsum("bcign,bcjgn->bcgij", Cc.double(), Bc.double()).float()
    tri = torch.tril(torch.ones((cl, cl), dtype=torch.bool))
    w = torch.exp(cum[:, :, -1:, :] - cum) * dtc
    S = torch.stack([_mm_split((w[..., h, None] * xc[..., h, :]).transpose(-1, -2),
                               Bc[:, :, :, h // rep], parts) for h in range(H)], dim=2)
    T, R = torch.zeros((b, H, P, N)), []
    for n in range(nc):                     # R[:, n]: the state entering chunk n
        R.append(T)
        T = torch.exp(cum[:, n, -1, :])[..., None, None] * T + S[:, n]
    R = torch.stack(R, dim=1)
    ys = []
    for h in range(H):
        seg = cum[..., :, None, h] - cum[..., None, :, h]
        W = CB[:, :, h // rep] * torch.exp(torch.where(tri, seg, -torch.inf)) \
            * dtc[:, :, None, :, h]
        inter = _mm_split(Cc[:, :, :, h // rep], R[:, :, h].transpose(-1, -2), parts,
                          split_a=False)
        ys.append(torch.exp(cum[..., h])[..., None] * inter
                  + _mm_split(W, xc[:, :, :, h], parts))
    return torch.stack(ys, dim=3).reshape(b, nc * cl, H, P)[:, :L], T


# as check_ssd draws them: small dt (trained Mamba2) and large dt with dt = 0 rows
SPLIT_CASES = {"small_dt": (0.01, 0.0, 2.0), "large_dt": (20.0, 0.2, 16.0)}


def _split_inputs(name):
    dt_scale, zero_dt, a_max = SPLIT_CASES[name]
    rng = np.random.default_rng(13)
    B, L, H, P, G, N = 2, 300, 4, 64, 1, 128
    x = torch.from_numpy(rng.standard_normal((B, L, H, P), dtype=np.float32)).bfloat16()
    dt = np.logaddexp(rng.standard_normal((B, L, H)), 0).astype(np.float32) * dt_scale
    dt = torch.from_numpy(dt * (rng.random((B, L, H)) >= zero_dt))
    A = -torch.from_numpy(np.exp(rng.random(H) * np.log(a_max)).astype(np.float32))
    Bm, Cm = (torch.from_numpy(0.5 * rng.standard_normal((B, L, G, N), dtype=np.float32))
              .bfloat16() for _ in range(2))
    return x, dt, A, Bm, Cm


def _pallas(x, dt, A, Bm, Cm, chunk):
    """The JAX Pallas kernel (interpret mode on the CPU, as in
    test_ssd_matches_pallas) on the same values; y rounded to x's dtype."""
    y, st = jax_ssd(*(jnp.asarray(_np(t)) for t in (x, dt, A, Bm, Cm)), chunk=chunk)
    return torch.from_numpy(_np(y)).to(x.dtype), torch.from_numpy(_np(st))


def _worst_over_limit(x, dt, A, Bm, Cm, chunk, parts, reference):
    """check_ssd's bf16 rule, per element: |d| <= 2**-6 |ref| + 1e-5 ref_abs on
    y (rounded to bf16, as the kernel stores it) and on the fp32 state, ref
    and ref_abs (the reference on |x|, |B|, |C|) from ``reference``;
    returns the largest |d| / limit of each."""
    y, st = _four_pass(x, dt, A, Bm, Cm, chunk, parts)
    yr, sr = reference(x, dt, A, Bm, Cm, chunk=chunk)
    ya, sa = reference(x.abs(), dt, A, Bm.abs(), Cm.abs(), chunk=chunk)

    def worst(out, ref, ref_abs):
        d = (out.float() - ref.float()).abs()
        lim = 2.0 ** -6 * ref.float().abs() + 1e-5 * ref_abs.float()
        return torch.where(d == 0, torch.zeros_like(d), d / lim).max().item()
    return worst(y.bfloat16(), yr, ya), worst(st, sr, sa)


@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("chunk", [256, 64])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_ssd_split_passes_within_the_chip_limits(case, chunk, parts):
    """Two parts are enough at these inputs; the kernel takes three (its
    state then stays within ~1% of the limit, not ~20%). Against the Pallas
    kernel at small dt only: at large dt its fp32 within-chunk cumsum (|cum|
    reaches thousands) moves its own y out of these limits against ssd_ref,
    whose cumsum is fp64 as the CUDA kernel's is."""
    arrs = _split_inputs(case)
    pallas = parts == 3 and case == "small_dt"
    for reference in (ssd_ref, _pallas) if pallas else (ssd_ref,):
        wy, ws = _worst_over_limit(*arrs, chunk, parts, reference)
        assert wy <= 1.0 and ws <= 1.0, (reference.__name__, wy, ws)


@pytest.mark.parametrize("chunk", [256, 64])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_ssd_single_bf16_pass_fails_the_chip_limits(case, chunk):
    """Why the kernel splits: with the fp32 operand rounded to bf16 once, the
    result leaves check_ssd's limits (y in every case; the state too at
    small dt, where every row reaches it)."""
    wy, ws = _worst_over_limit(*_split_inputs(case), chunk, 1, ssd_ref)
    assert wy > 1.0 and (ws > 1.0 or case == "large_dt"), (wy, ws)


# ---------------------------------------------------------------------------
# the mamba2 block, function by function
# ---------------------------------------------------------------------------

CFG = dict(state_dim=16, head_dim=16, expand=2, n_groups=2, conv_width=4,
           chunk_size=8)
D_MODEL = 32


def _params(seed: int = 0) -> dict:
    """numpy values for every leaf of mamba_specs (A_log as the a_log init
    draws it, the biases and D away from their zero/one inits)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in TM.mamba_specs(SSMConfig(**CFG), D_MODEL).items():
        v = rng.standard_normal(s.shape).astype(np.float32)
        if name == "A_log":
            v = np.log(rng.uniform(1.0, 16.0, s.shape)).astype(np.float32)
        elif name in ("norm", "D"):
            v = 1.0 + 0.1 * v
        else:
            v = v * (0.1 if name.endswith("_b") or name == "dt_bias" else s.stddev)
        out[name] = v
    return out


def test_causal_conv_and_step_match():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 24), dtype=np.float32)
    w = rng.standard_normal((4, 24), dtype=np.float32)
    b = rng.standard_normal(24, dtype=np.float32)
    want = JM.causal_conv(*(jnp.asarray(a) for a in (x, w, b)))
    got = TM.causal_conv(*(torch.from_numpy(a) for a in (x, w, b)))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    state = rng.standard_normal((2, 3, 24), dtype=np.float32)
    wo, ws = JM.causal_conv_step(*(jnp.asarray(a) for a in (x[:, 0], state, w, b)))
    go, gs = TM.causal_conv_step(*(torch.from_numpy(a) for a in (x[:, 0], state, w, b)))
    np.testing.assert_allclose(_np(go), _np(wo), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_np(gs), _np(ws))


def test_ssd_decode_step_matches():
    rng = np.random.default_rng(3)
    b, H, P, N, G = 2, 4, 8, 16, 2
    state = rng.standard_normal((b, H, P, N), dtype=np.float32)
    x = rng.standard_normal((b, H, P), dtype=np.float32)
    dt = np.logaddexp(rng.standard_normal((b, H)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bt = rng.standard_normal((b, G, N), dtype=np.float32)
    Ct = rng.standard_normal((b, G, N), dtype=np.float32)
    arrs = (state, x, dt, A, Bt, Ct)
    wy, ws = JM.ssd_decode_step(*(jnp.asarray(a) for a in arrs))
    gy, gs = TM.ssd_decode_step(*(torch.from_numpy(a) for a in arrs))
    np.testing.assert_allclose(_np(gy), _np(wy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(gs), _np(ws), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("L", [13, 3])        # ragged chunks; shorter than the conv
def test_mamba_forward_with_state_matches(L):
    p = _params()
    x = np.random.default_rng(4).standard_normal((2, L, D_MODEL), dtype=np.float32)
    kw = dict(d_model=D_MODEL, dtype=jnp.float32, return_state=True)
    with runtime.pallas_enabled(interpret=True):
        wy, wc = JM.mamba_forward({k: jnp.asarray(v) for k, v in p.items()},
                                  JaxSSMConfig(**CFG), jnp.asarray(x), **kw)
    kw["dtype"] = torch.float32
    gy, gc = TM.mamba_forward({k: torch.from_numpy(v) for k, v in p.items()},
                              SSMConfig(**CFG), torch.from_numpy(x), **kw)
    np.testing.assert_allclose(_np(gy), _np(wy), rtol=1e-4, atol=1e-4)
    assert sorted(gc) == sorted(wc)
    for k in wc:
        np.testing.assert_allclose(_np(gc[k]), _np(wc[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_mamba_decode_matches_and_updates_in_place():
    p = _params(1)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 1, D_MODEL), dtype=np.float32)
    cache = {k: rng.standard_normal(np.shape(v), dtype=np.float32)
             for k, v in JM.mamba_cache_init(JaxSSMConfig(**CFG), 2, D_MODEL,
                                             jnp.float32).items()}
    wy, wc = JM.mamba_decode({k: jnp.asarray(v) for k, v in p.items()},
                             JaxSSMConfig(**CFG), jnp.asarray(x),
                             {k: jnp.asarray(v) for k, v in cache.items()},
                             d_model=D_MODEL, dtype=jnp.float32)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    ptrs = {k: t.data_ptr() for k, t in tcache.items()}
    gy, gc = TM.mamba_decode({k: torch.from_numpy(v) for k, v in p.items()},
                             SSMConfig(**CFG), torch.from_numpy(x), tcache,
                             d_model=D_MODEL, dtype=torch.float32)
    np.testing.assert_allclose(_np(gy), _np(wy), rtol=1e-5, atol=1e-5)
    for k in wc:
        np.testing.assert_allclose(_np(gc[k]), _np(wc[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
        assert gc[k].data_ptr() == ptrs[k]       # written in place
