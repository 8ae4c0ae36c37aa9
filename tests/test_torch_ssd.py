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
