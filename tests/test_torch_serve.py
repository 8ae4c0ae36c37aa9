"""The port's serving surface on the CPU: greedy tokens equal the JAX
package's ``greedy_generate`` (fp32, same weights, same prompts), and the
session's token stream is contiguous across decode calls."""
import dataclasses
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ParallelConfig
from repro.config import get_smoke as jax_get_smoke
from repro.kernels import runtime
from repro.launch.serve import ServeSession as JaxServeSession
from repro.models import Model as JaxModel
from repro.serve import greedy_generate as jax_greedy_generate
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.serve import ServeSession
from repro_torch.serve import greedy_generate


def test_make_batch_draws_the_jax_prompts():
    sess = ServeSession("smollm-360m", smoke=True, device="cpu")
    # the JAX session cannot be built unsharded; its make_batch reads cfg only
    jax_self = types.SimpleNamespace(cfg=jax_get_smoke("smollm-360m"))
    want = JaxServeSession.make_batch(jax_self, 3, 11, seed=5)["tokens"]
    got = sess.make_batch(3, 11, seed=5)["tokens"]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_session_tokens_equal_jax_greedy_generate():
    cfg = dataclasses.replace(jax_get_smoke("smollm-360m"), dtype="float32")
    jm = JaxModel(cfg, ParallelConfig(remat="none", moe_impl="dense"))
    params = jm.init(jax.random.PRNGKey(4))
    sess = ServeSession("smollm-360m", smoke=True, device="cpu", dtype="float32")
    sess.model.load_params(params_from_numpy(jax.tree_util.tree_map(np.asarray, params)))
    batch = sess.make_batch(2, 12, seed=2)
    with runtime.pallas_enabled(interpret=True):
        want = jax_greedy_generate(jm, params, jnp.asarray(batch["tokens"].numpy()), 8)
    gen, tp, td = sess.generate(batch, 8)
    np.testing.assert_array_equal(gen.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        greedy_generate(sess.model, batch["tokens"], 8).numpy(), np.asarray(want))


def test_danube_session_tokens_equal_jax_greedy_generate():
    """h2o-danube-1.8b's smoke config (sliding window 64 on every layer):
    a 70-token prompt fills the 64-slot ring past its window before decode."""
    cfg = dataclasses.replace(jax_get_smoke("h2o-danube-1.8b"), dtype="float32")
    jm = JaxModel(cfg, ParallelConfig(remat="none", moe_impl="dense"))
    params = jm.init(jax.random.PRNGKey(6))
    sess = ServeSession("h2o-danube-1.8b", smoke=True, device="cpu", dtype="float32")
    sess.model.load_params(params_from_numpy(jax.tree_util.tree_map(np.asarray, params)))
    batch = sess.make_batch(2, 70, seed=2)
    with runtime.pallas_enabled(interpret=True):
        want = jax_greedy_generate(jm, params, jnp.asarray(batch["tokens"].numpy()), 8)
    gen, _, _ = sess.generate(batch, 8)
    np.testing.assert_array_equal(gen.numpy(), np.asarray(want))
    assert sess._caches[0][0]["kv"]["k"].shape[2] == cfg.attention.sliding_window


def test_deepseek_session_tokens_equal_jax_greedy_generate():
    """deepseek-v2-lite-16b's smoke config (MLA with its latent cache, a
    dense first layer, then MoE layers with a shared expert): the session's
    greedy stream, split over two decode calls, equals the JAX package's
    ``greedy_generate``, and its caches are the latent ones."""
    cfg = dataclasses.replace(jax_get_smoke("deepseek-v2-lite-16b"), dtype="float32")
    jm = JaxModel(cfg, ParallelConfig(remat="none", moe_impl="dense"))
    params = jm.init(jax.random.PRNGKey(8))
    sess = ServeSession("deepseek-v2-lite-16b", smoke=True, device="cpu", dtype="float32")
    sess.model.load_params(params_from_numpy(jax.tree_util.tree_map(np.asarray, params)))
    batch = sess.make_batch(2, 20, seed=2)
    with runtime.pallas_enabled(interpret=True):
        want = jax_greedy_generate(jm, params, jnp.asarray(batch["tokens"].numpy()), 10)
    sess.prefill(batch)
    a, _ = sess.decode_step(4)
    b, _ = sess.decode_step(6)
    np.testing.assert_array_equal(torch.cat([a, b], dim=1).numpy(), np.asarray(want))
    kv = sess._caches[1][0]["kv"]
    assert sorted(kv) == ["ckv", "k_rope", "pos"]
    assert kv["ckv"].shape[-1] == cfg.attention.kv_lora_rank


def test_serve_session_stream_is_contiguous():
    """Two chained decode_step calls equal one generate of the same total."""
    sess = ServeSession("smollm-360m", smoke=True, device="cpu")
    batch = sess.make_batch(2, 8, seed=3)
    gen, tp, td = sess.generate(batch, 6)
    assert gen.shape == (2, 6)
    assert (tp.phase, tp.batch, tp.tokens) == ("prefill", 2, 16)
    assert (td.phase, td.batch, td.tokens) == ("decode", 2, 12)
    assert tp.seconds >= 0.0 and td.tokens_per_s > 0.0

    sess2 = ServeSession("smollm-360m", smoke=True, device="cpu")
    sess2.prefill(batch)
    a, _ = sess2.decode_step(2)
    b, _ = sess2.decode_step(4)
    np.testing.assert_array_equal(torch.cat([a, b], dim=1).numpy(), gen.numpy())


def test_restart_drops_state_and_restores_weights():
    sess = ServeSession("smollm-360m", smoke=True, device="cpu", seed=7)
    before = sess.model.params_tree()["embed"]["tok"].clone()
    batch = sess.make_batch(1, 5)
    gen, _, _ = sess.generate(batch, 3)
    with torch.no_grad():
        sess.model.params["embed"]["tok"].add_(1.0)
    tr = sess.restart()
    assert (tr.phase, tr.tokens) == ("restart", 0)
    with pytest.raises(RuntimeError, match="before prefill"):
        sess.decode_step()
    assert torch.equal(sess.model.params_tree()["embed"]["tok"], before)
    again, _, _ = sess.generate(batch, 3)
    assert torch.equal(again, gen)


def test_session_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the check is for machines without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeSession("smollm-360m", smoke=True)


def test_cli_serves_on_the_cpu(monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "smollm-360m", "--smoke", "--device", "cpu",
        "--batch", "2", "--prompt-len", "6", "--gen", "3", "--restarts", "1"])
    serve_cli.main()


def test_mamba_session_tokens_equal_jax_greedy_generate():
    cfg = dataclasses.replace(jax_get_smoke("mamba2-1.3b"), dtype="float32")
    jm = JaxModel(cfg, ParallelConfig(remat="none", moe_impl="dense"))
    params = jm.init(jax.random.PRNGKey(5))
    sess = ServeSession("mamba2-1.3b", smoke=True, device="cpu", dtype="float32")
    sess.model.load_params(params_from_numpy(jax.tree_util.tree_map(np.asarray, params)))
    batch = sess.make_batch(2, 37, seed=2)       # a chunk of 32, a ragged one of 5
    with runtime.pallas_enabled(interpret=True):
        want = jax_greedy_generate(jm, params, jnp.asarray(batch["tokens"].numpy()), 8)
    gen, _, _ = sess.generate(batch, 8)
    np.testing.assert_array_equal(gen.numpy(), np.asarray(want))


def test_mamba_session_stream_is_contiguous():
    sess = ServeSession("mamba2-1.3b", smoke=True, device="cpu")
    batch = sess.make_batch(2, 9, seed=3)
    gen, _, _ = sess.generate(batch, 6)
    sess.prefill(batch)
    a, _ = sess.decode_step(2)
    b, _ = sess.decode_step(4)
    np.testing.assert_array_equal(torch.cat([a, b], dim=1).numpy(), gen.numpy())
    assert int(gen.min()) >= 0 and int(gen.max()) < sess.cfg.padded_vocab
