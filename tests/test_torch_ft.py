"""The port's §6.1 fault-tolerance modules on the CPU against the JAX
package's: the copied modules (failure taxonomy, synthetic logs, log agent,
diagnosis, two-round detection, spike detector, supervisor) fed the same
inputs; the checkpoint adapter with torch trees (the properties of
tests/test_checkpoint.py, the aliasing of the RAM cache with a state updated
in place, and checkpoints crossing between the two packages both ways).

The elastic case of tests/test_checkpoint.py (restore under another
sharding) waits for the port's device mesh (ROADMAP Queue 1 item 12): the
port's ``restore`` has no ``shardings`` argument yet."""
import dataclasses
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_smoke as jax_get_smoke
from repro.core.ft import checkpoint as jckpt
from repro.core.ft import detection as jdet
from repro.core.ft import diagnosis as jdiag
from repro.core.ft import events as jev
from repro.core.ft import log_agent as jagent
from repro.core.ft import spike as jspike
from repro.core.ft import supervisor as jsup
from repro.models import Model as JaxModel
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro_torch import config as tcfg
from repro_torch.bridge import adam_state_from_numpy, params_from_numpy
from repro_torch.core.ft import checkpoint as tckpt
from repro_torch.core.ft import detection as tdet
from repro_torch.core.ft import diagnosis as tdiag
from repro_torch.core.ft import events as tev
from repro_torch.core.ft import log_agent as tagent
from repro_torch.core.ft import spike as tspike
from repro_torch.core.ft import supervisor as tsup
from repro_torch.models import Model
from repro_torch.train import optimizer as topt

PKGS = {"jax": (jev, jdiag, jdet, jspike, jsup, jckpt),
        "port": (tev, tdiag, tdet, tspike, tsup, tckpt)}


# ---------------------------------------------------------------------------
# the copied modules
# ---------------------------------------------------------------------------

def test_table3_equals_jax_field_for_field():
    assert len(tev.TABLE3) == len(jev.TABLE3) >= 20
    for ours, theirs in zip(tev.TABLE3, jev.TABLE3):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert list(tev.BY_NAME) == list(jev.BY_NAME)
    assert (tev.INFRA, tev.FRAMEWORK, tev.SCRIPT) == (jev.INFRA, jev.FRAMEWORK, jev.SCRIPT)
    for seed in range(5):
        assert (tev.sample_failure(random.Random(seed)).name
                == jev.sample_failure(random.Random(seed)).name)


@pytest.mark.parametrize("flavor,cascade", [("train", True), ("serve", True),
                                            ("train", False)])
def test_generate_log_equals_jax(flavor, cascade):
    for ft, jft in zip(tev.TABLE3, jev.TABLE3):
        for seed in (0, 7):
            kw = dict(seed=seed, n_normal=40, flavor=flavor, cascade=cascade)
            assert tev.generate_log(ft, **kw) == jev.generate_log(jft, **kw), ft.name
    assert tev.generate_log(None, seed=3) == jev.generate_log(None, seed=3)


def test_log_agent_equals_jax():
    assert tagent.LOG_AGENT_PROMPT == jagent.LOG_AGENT_PROMPT
    assert tagent.FAILURE_AGENT_PROMPT == jagent.FAILURE_AGENT_PROMPT
    log = tev.generate_log(tev.BY_NAME["NVLinkError"], seed=1, n_normal=60)
    for line in log[-12:]:
        assert tagent.template_of(line) == jagent.template_of(line)
        assert tagent.looks_like_error(line) == jagent.looks_like_error(line)
        t = tagent.template_of(line)
        assert tagent.template_to_regex(t) == jagent.template_to_regex(t)
    prompt = tagent.LOG_AGENT_PROMPT.format(segment="\n".join(log[-40:]))
    for seed in range(3):
        assert (tagent.OfflineLLM().complete(prompt, seed=seed)
                == jagent.OfflineLLM().complete(prompt, seed=seed))
    assert (tagent.self_consistent(tagent.OfflineLLM(), prompt, key="filter_regexes")
            == jagent.self_consistent(jagent.OfflineLLM(), prompt, key="filter_regexes"))


def test_diagnosis_over_taxonomy_equals_jax():
    """Every failure type's logs as tests/test_ft.py draws them; one system
    per package, fed in the same order, so the rules each learns agree too."""
    ours, theirs = tdiag.FailureDiagnosisSystem(), jdiag.FailureDiagnosisSystem()
    correct = 0
    for ft, jft in zip(tev.TABLE3, jev.TABLE3):
        for seed in range(3):
            a = ours.diagnose(tev.generate_log(ft, seed=seed, n_normal=120))
            b = theirs.diagnose(jev.generate_log(jft, seed=seed, n_normal=120))
            assert dataclasses.asdict(a) == dataclasses.asdict(b), (ft.name, seed)
            assert tdiag.verdict_class(a) == jdiag.verdict_class(b)
            correct += a.failure == ft.name
    assert correct / (3 * len(tev.TABLE3)) >= 0.9
    comp, jcomp = tdiag.LogCompressor(), jdiag.LogCompressor()
    log = tev.generate_log(tev.BY_NAME["CUDAError"], seed=0, n_normal=500)
    assert comp.compress(log) == jcomp.compress(log)
    assert comp.compression_ratio == jcomp.compression_ratio


def test_two_round_detection_equals_jax():
    rng = np.random.default_rng(0)
    for _ in range(40):
        n = int(rng.integers(2, 65))
        faulty = set(rng.choice(n, size=int(rng.integers(0, max(n // 3, 1) + 1)),
                                replace=False).tolist())
        a, b = tdet.SimulatedFleet(n, faulty=set(faulty)), jdet.SimulatedFleet(n, faulty=set(faulty))
        ra = tdet.two_round_detection(a.healthy_nodes(), a)
        rb = jdet.two_round_detection(b.healthy_nodes(), b)
        assert dataclasses.asdict(ra) == dataclasses.asdict(rb)
        assert set(ra.faulty) == faulty and a.probes_run == b.probes_run
    mons = [tdet.StragglerMonitor(range(8), min_samples=8),
            jdet.StragglerMonitor(range(8), min_samples=8)]
    for _ in range(12):
        for h in range(8):
            t = 1.0 + (0.6 if h == 3 else 0.0) + 0.01 * float(rng.random())
            for m in mons:
                m.record(h, t)
    assert mons[0].stragglers() == mons[1].stragglers() == [3]


def _losses(kind: str) -> list[float]:
    rng = np.random.default_rng(len(kind))
    out = []
    for s in range(200):
        loss = 2.0 - 0.002 * s + 0.02 * float(rng.standard_normal())
        if kind == "step" and s >= 120:
            loss += 4.0
        if kind == "blips" and s % 50 == 10:
            loss += 5.0
        if kind == "nan" and s >= 150:
            loss = float("nan")
        out.append(loss)
    return out


@pytest.mark.parametrize("kind", ["step", "blips", "nan"])
@pytest.mark.parametrize("patience", [2, 3, 4])
def test_spike_detector_events_equal_jax(kind, patience):
    dets = [tspike.SpikeDetector(min_history=8, patience=patience),
            jspike.SpikeDetector(min_history=8, patience=patience)]
    events = ([], [])
    for s, loss in enumerate(_losses(kind)):
        for det, evs in zip(dets, events):
            ev = det.update(s, loss, available_ckpts=[0, 40, 80, 110])
            if ev is not None:
                evs.append(dataclasses.asdict(ev))
                det.reset_after_rollback(ev.rollback_step)
    assert events[0] == events[1]
    assert events[0] or kind == "blips"


# the scripted jobs of tests/test_ft.py, one function each, run by both packages

def _job_end_to_end(pkg, tmp):
    ev, diag, det, _, sup, ck = pkg
    ckpt = ck.CheckpointManager(str(tmp), keep=5)
    fleet = det.SimulatedFleet(16)
    fired = set()
    schedule = [(25, "NVLinkError"), (57, "ConnectionError")]

    def job(ctx):
        for step in range(ctx.start_step, 80):
            if step % 10 == 0:
                ckpt.save_async(step, {"step": np.int64(step)})
            for fs, fname in schedule:
                if step == fs and fs not in fired:
                    fired.add(fs)
                    if ev.BY_NAME[fname].needs_node_cordon:
                        fleet.fail({3})
                    raise sup.JobFailure(step, ev.generate_log(ev.BY_NAME[fname], seed=step),
                                         truth=fname)
        return 80
    return sup.Supervisor(ckpt, diag.FailureDiagnosisSystem(), fleet), job, ckpt, fleet


def _job_script_error(pkg, tmp):
    ev, diag, det, _, sup, ck = pkg
    ckpt = ck.CheckpointManager(str(tmp), keep=2)
    fleet = det.SimulatedFleet(4)
    s = sup.Supervisor(ckpt, diag.FailureDiagnosisSystem(), fleet)
    s.on_manual = lambda d: None
    fired = []

    def job(ctx):
        if not fired:
            fired.append(1)
            raise sup.JobFailure(3, ev.generate_log(ev.BY_NAME["SyntaxError"], seed=0),
                                 truth="SyntaxError")
        return 10
    return s, job, ckpt, fleet


def _job_spike_rollback(pkg, tmp):
    ev, diag, det, spike, sup, ck = pkg
    ckpt = ck.CheckpointManager(str(tmp), keep=8, ram_cache_slots=8)
    fleet = det.SimulatedFleet(4)
    spiked = []
    seen = []

    def job(ctx):
        seen.append(dict(ctx.resume_extra))
        for step in range(ctx.start_step, 60):
            if step % 10 == 0:
                ckpt.save_async(step, {"step": np.int64(step)}, extra={"data_step": step})
            if step == 37 and not spiked:
                spiked.append(step)
                raise sup.SpikeInterrupt(spike.SpikeEvent(
                    onset_step=35, detect_step=37, rollback_step=20,
                    skip_range=(30, 40), baseline=2.0, peak=9.0))
        return 60
    job.seen = seen
    return sup.Supervisor(ckpt, diag.FailureDiagnosisSystem(), fleet), job, ckpt, fleet


@pytest.mark.parametrize("build", [_job_end_to_end, _job_script_error, _job_spike_rollback])
def test_supervisor_reports_equal_jax(build, tmp_path):
    reports = {}
    for name, pkg in PKGS.items():
        sup, job, ckpt, fleet = build(pkg, tmp_path / name)
        rep = sup.run(job)
        ckpt.wait()
        ckpt.close()
        reports[name] = (dataclasses.asdict(rep), rep.auto_recoveries,
                         rep.manual_interventions, rep.lost_steps,
                         rep.diagnosis_accuracy, sorted(fleet.cordoned),
                         ckpt.available_steps(), getattr(job, "seen", None))
    assert reports["port"] == reports["jax"]
    assert reports["port"][0]["completed"]


# ---------------------------------------------------------------------------
# the checkpoint adapter
# ---------------------------------------------------------------------------

def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.standard_normal((64, 32), dtype=np.float32)),
            "opt": {"m": torch.ones(64, 32), "step": torch.tensor(7, dtype=torch.int32)}}


def _zeros_like(state):
    return topt.tree_map(torch.zeros_like, state)


def _equal(a, b) -> bool:
    la, lb = topt.tree_leaves(a), topt.tree_leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y)
                                      for x, y in zip(la, lb))


def test_roundtrip_async_in_place(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=3)
    state = _state()
    stall = mgr.save_async(10, state, extra={"data_step": 11})
    mgr.wait()
    assert stall < 5.0
    template = _zeros_like(state)
    restored, extra = mgr.restore(10, template)
    assert restored is template and _equal(state, restored)
    assert extra["data_step"] == 11
    mgr.close()


def test_restore_from_disk_after_cache_eviction(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=8, ram_cache_slots=1)
    states = {s: _state(s) for s in (1, 2, 3)}
    for s, st in states.items():
        mgr.save_async(s, st)
    mgr.wait()
    assert list(mgr.ram_cache) == [3]
    restored, _ = mgr.restore(1, _zeros_like(states[1]))     # from disk
    assert _equal(states[1], restored)
    mgr.close()


def test_keep_gc(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2)
    for s in range(5):
        mgr.save_sync(s, _state(s))
    assert mgr.available_steps() == [3, 4]
    mgr.close()


def test_latest_restorable_prefers_ram(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=3, storage_bandwidth_gbps=0.01)
    mgr.save_async(5, _state())
    assert mgr.latest_restorable() == 5                     # persist still in flight
    mgr.wait(timeout=60)
    assert mgr.latest_step() == 5
    mgr.close()


def test_async_stall_much_smaller_than_sync(tmp_path):
    big = {"w": torch.ones(512, 1024)}                      # 2 MiB
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2, storage_bandwidth_gbps=0.05)
    t_sync = mgr.save_sync(1, big)
    t_async = mgr.save_async(2, big)
    mgr.wait(timeout=60)
    assert t_async < t_sync / 3, (t_sync, t_async)
    mgr.close()


def test_atomic_commit_no_partial_dirs(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=4)
    for s in range(3):
        mgr.save_async(s, _state(s))
    mgr.wait()
    for name in os.listdir(tmp_path):
        assert not name.endswith(".tmp")
        assert os.path.exists(os.path.join(tmp_path, name, "manifest.json"))
    mgr.close()


def test_available_steps_skips_malformed_entries(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=8)
    mgr.save_sync(5, _state())
    mgr.save_sync(12, _state())
    for junk in ("step_final", "step_12_copy", "step_", "step_abc"):
        os.makedirs(tmp_path / junk)
        (tmp_path / junk / "manifest.json").write_text("{}")
    (tmp_path / "step_99").write_text("not a checkpoint")
    assert mgr.available_steps() == [5, 12]
    assert mgr.latest_step() == 12
    mgr.close()


def test_restore_checks_its_template(tmp_path):
    """Another leaf count, a leaf of another shape, or a template leaf that
    is not a tensor, raises; a bfloat16 leaf cannot be snapshotted (numpy
    has no bfloat16)."""
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2)
    state = _state()
    mgr.save_sync(1, state)
    with pytest.raises(ValueError, match="leaf count"):
        mgr.restore(1, {"w": torch.zeros(64, 32)})
    bad = _zeros_like(state)
    bad["w"] = torch.zeros(32, 64)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, bad)
    bad["w"] = np.zeros((64, 32), np.float32)
    with pytest.raises(TypeError):
        mgr.restore(1, bad)
    with pytest.raises(TypeError, match="bfloat16"):
        mgr.save_async(2, {"w": torch.zeros(3, dtype=torch.bfloat16)})
    mgr.close()


@pytest.mark.parametrize("slots", [2, 0])
def test_ram_cache_does_not_alias_a_state_updated_in_place(tmp_path, slots):
    """save_async, one in-place AdamW step, then two restores of the same
    step (from the RAM cache, or with no cache from disk), each followed by
    another in-place step: both restores give the state at save time."""
    rng = np.random.default_rng(0)
    params = {"a": torch.from_numpy(rng.standard_normal((8, 4), dtype=np.float32)),
              "b": [torch.from_numpy(rng.standard_normal(5, dtype=np.float32))]}
    opt = topt.adamw_init(params)
    cfg = tcfg.TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=10)
    grads = topt.tree_map(lambda p: torch.ones_like(p), params)
    topt.adamw_update(grads, opt, params, cfg)
    saved = topt.tree_map(torch.clone, (params, opt))
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2, ram_cache_slots=slots)
    mgr.save_async(1, (params, opt))
    mgr.wait()
    assert (1 in mgr.ram_cache) == bool(slots)
    for _ in range(2):
        topt.adamw_update(grads, opt, params, cfg)
        assert not _equal(saved, (params, opt))
        (p, o), _ = mgr.restore(1, (params, opt))
        assert p is params and o is opt
        assert _equal(saved, (params, opt))
    mgr.close()


# both directions of the on-disk format

def _port_cfg(cfg) -> tcfg.ModelConfig:
    d = dataclasses.asdict(cfg)
    d["attention"] = tcfg.AttentionConfig(**d["attention"])
    d["moe"] = tcfg.MoEConfig(**d["moe"])
    d["ssm"] = None
    return tcfg.ModelConfig(**d)


EXTRA = {"data_step": 13, "skip_ranges": [[4, 9]]}


def _jax_state():
    cfg = jax_get_smoke("smollm-360m")
    params = JaxModel(cfg).init(jax.random.PRNGKey(3))
    opt = jax_adamw_init(params)
    # m, v and the step away from their init, so a zero would show
    opt = opt._replace(m=jax.tree_util.tree_map(lambda p: 0.5 * p, params),
                       v=jax.tree_util.tree_map(lambda p: p * p, params),
                       step=jnp.int32(13))
    return cfg, params, opt


def _port_template(cfg):
    model = Model(_port_cfg(cfg), device="cpu", seed=1)
    params = model.params_tree()
    return params, topt.adamw_init(params)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    cfg, params, opt = _jax_state()
    jm = jckpt.CheckpointManager(str(tmp_path), keep=2)
    jm.save_sync(13, (params, opt), extra=EXTRA)
    jm.close()
    want_p = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    want_o = adam_state_from_numpy(*jax.tree_util.tree_map(np.asarray, (opt.m, opt.v)), 13)
    tm = tckpt.CheckpointManager(str(tmp_path), keep=2)
    assert tm.available_steps() == [13]
    (p, o), extra = tm.restore(13, _port_template(cfg))
    assert _equal((p, o), (want_p, want_o)) and extra == EXTRA
    tm.close()


def test_port_checkpoint_restores_in_jax_with_the_same_manifest(tmp_path):
    cfg, params, opt = _jax_state()
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    topt_state = adam_state_from_numpy(*jax.tree_util.tree_map(np.asarray, (opt.m, opt.v)), 13)
    tm = tckpt.CheckpointManager(str(tmp_path / "port"), keep=2)
    tm.save_sync(13, (tparams, topt_state), extra=EXTRA)
    tm.close()
    jm = jckpt.CheckpointManager(str(tmp_path / "port"), keep=2)
    template = jax.tree_util.tree_map(jnp.zeros_like, (params, opt))
    (rp, ro), extra = jm.restore(13, template)
    assert extra == EXTRA
    want = jax.tree_util.tree_leaves((params, opt))
    got = jax.tree_util.tree_leaves((rp, ro))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ref = jckpt.CheckpointManager(str(tmp_path / "jax"), keep=2)
    ref.save_sync(13, (params, opt), extra=EXTRA)
    ref.close()
    jm.close()
    manifests = [(tmp_path / d / "step_00000013" / "manifest.json").read_text()
                 for d in ("port", "jax")]
    assert manifests[0] == manifests[1]
    assert json.loads(manifests[0])["num_leaves"] == len(want)
