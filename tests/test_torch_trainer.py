"""The port's Trainer under its Supervisor on the CPU: the two scenarios of
tests/test_trainer_integration.py, the spike scenario against the JAX
package's Trainer, exact resumption (every restore gives the parameter bits
of an uninterrupted run), and the training CLI.

The JAX Trainer builds a mesh-constrained train step that raises on this
JAX (see ROADMAP "Standing notes"); the comparison swaps in the unsharded
model and ``jax.jit(make_train_step(...))`` in this file, and hands the port
JAX's initial parameters through ``repro_torch.bridge``. It runs both in
fp32 compute: in bf16 the two packages round at different places (see
tests/test_torch_train.py) and already differ by ~3e-4 relative in the loss
of step 1, from the same state."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.config import ParallelConfig as JaxParallel
from repro.config import TrainConfig as JaxTrain
from repro.config import get_smoke as jax_get_smoke
from repro.core.ft.checkpoint import CheckpointManager as JaxCkpt
from repro.core.ft.detection import SimulatedFleet as JaxFleet
from repro.core.ft.diagnosis import FailureDiagnosisSystem as JaxDiagnosis
from repro.core.ft.events import BY_NAME as JAX_BY_NAME
from repro.core.ft.supervisor import Supervisor as JaxSupervisor
from repro.launch.mesh import make_host_mesh
from repro.launch.train import Trainer as JaxTrainer
from repro.models import Model as JaxModel
from repro.sharding import make_rules
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch import config as tcfg
from repro_torch.bridge import params_from_numpy
from repro_torch.core.ft.checkpoint import CheckpointManager
from repro_torch.core.ft.detection import SimulatedFleet
from repro_torch.core.ft.diagnosis import FailureDiagnosisSystem
from repro_torch.core.ft.events import BY_NAME
from repro_torch.core.ft.supervisor import JobContext, Supervisor
from repro_torch.launch import train as ttrain
from repro_torch.launch.train import Trainer
from repro_torch.models import Model
from repro_torch.train.optimizer import tree_leaves

SRC = Path(__file__).resolve().parents[1] / "src"
TRAIN = dict(global_batch=2, seq_len=32, warmup_steps=5, learning_rate=1e-3)
SPIKE = dict(fault=(17, "ECCError"), spike={30 + i: 8.0 for i in range(5)})


def _trainer(tmp_path, steps=50, *, dtype=None, keep=4, ram_cache_slots=2,
             ckpt_every=10, **kw):
    cfg = tcfg.get_smoke("smollm-360m")
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = Model(cfg, tcfg.ParallelConfig(remat="none", moe_impl="dense"),
                  device="cpu")
    tc = tcfg.TrainConfig(total_steps=steps, **TRAIN)
    ckpt = CheckpointManager(str(tmp_path), keep=keep, ram_cache_slots=ram_cache_slots)
    return Trainer(model, tc, ckpt, total_steps=steps, ckpt_every=ckpt_every,
                   log_every=10 ** 9, **kw), ckpt


def _run(trainer, ckpt, fleet=None):
    """The supervised run; also returns the skip ranges of its last attempt."""
    ctxs = []

    def job(ctx):
        ctxs.append(ctx)
        return trainer.job(ctx)
    report = Supervisor(ckpt, FailureDiagnosisSystem(), fleet or SimulatedFleet(8)).run(job)
    ckpt.wait()
    ckpt.close()
    return report, ctxs[-1].skip_ranges


# ---------------------------------------------------------------------------
# the scenarios of tests/test_trainer_integration.py
# ---------------------------------------------------------------------------

def test_trainer_recovers_and_skips_spike_data(tmp_path):
    trainer, ckpt = _trainer(tmp_path, steps=50,
                             fault_schedule={17: BY_NAME["ECCError"]},
                             spike_schedule={30 + i: 8.0 for i in range(5)})
    report, _ = _run(trainer, ckpt)
    assert report.completed and report.final_step == 50
    kinds = [e.kind for e in report.events]
    assert "failure" in kinds and "spike" in kinds
    spike = next(e for e in report.events if e.kind == "spike")
    assert spike.resumed_from <= 30          # pre-onset checkpoint
    losses = [l for _, l in trainer.history]
    assert np.isfinite(losses[-1]) and losses[-1] < losses[0]


def test_trainer_cordons_stragglers(tmp_path):
    fleet = SimulatedFleet(8)
    times = lambda step: {h: 1.0 + (0.8 if h == 5 else 0.0) + 0.001 * step  # noqa: E731
                          for h in range(8)}
    trainer, ckpt = _trainer(tmp_path, steps=15, fleet=fleet, host_time_fn=times)
    report, _ = _run(trainer, ckpt, fleet)
    assert report.completed
    assert 5 in fleet.cordoned               # persistent straggler removed
    assert len(fleet.cordoned) == 1          # and only it


# ---------------------------------------------------------------------------
# the slice against the JAX package
# ---------------------------------------------------------------------------

def _jax_spike_run(tmp_path, cfg):
    parallel = JaxParallel(remat="none", moe_impl="dense")
    tc = JaxTrain(total_steps=50, **TRAIN)
    mesh = make_host_mesh()
    ckpt = JaxCkpt(str(tmp_path), keep=4)
    trainer = JaxTrainer(JaxModel(cfg, parallel, make_rules(mesh, parallel)), tc, mesh,
                         parallel, ckpt, total_steps=50, ckpt_every=10, log_every=10 ** 9,
                         fault_schedule={SPIKE["fault"][0]: JAX_BY_NAME[SPIKE["fault"][1]]},
                         spike_schedule=SPIKE["spike"])
    model = JaxModel(cfg, parallel)
    trainer.model = model
    trainer.step_fn = jax.jit(jax_make_train_step(model, tc))
    report = JaxSupervisor(ckpt, JaxDiagnosis(), JaxFleet(8)).run(trainer.job)
    ckpt.wait()
    ckpt.close()
    init = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(tc.seed)))
    return report, trainer.history, init


def _events(report) -> list:
    return [(e.attempt, e.kind, e.step, e.resumed_from, e.lost_steps, e.manual, e.truth,
             e.diagnosis and dataclasses.asdict(e.diagnosis),
             e.detection and dataclasses.asdict(e.detection)) for e in report.events]


def test_spike_scenario_equals_jax_trainer(tmp_path):
    """The same events, and the loss of every one of the 60 entries to 1e-4
    relative (fp32 compute; measured ~2e-7)."""
    cfg = dataclasses.replace(jax_get_smoke("smollm-360m"), dtype="float32")
    jreport, jhistory, init = _jax_spike_run(tmp_path / "jax", cfg)
    trainer, ckpt = _trainer(tmp_path / "port", steps=50, dtype="float32",
                             fault_schedule={SPIKE["fault"][0]: BY_NAME[SPIKE["fault"][1]]},
                             spike_schedule=SPIKE["spike"])
    trainer.initial_params = lambda: params_from_numpy(init)
    report, _ = _run(trainer, ckpt)
    assert _events(report) == _events(jreport)
    assert [e.kind for e in report.events] == ["failure", "spike", "done"]
    assert (report.completed, report.final_step, report.attempts) == \
        (jreport.completed, jreport.final_step, jreport.attempts)
    assert [s for s, _ in trainer.history] == [s for s, _ in jhistory]
    assert len(jhistory) == 60
    np.testing.assert_allclose([l for _, l in trainer.history], [l for _, l in jhistory],
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# exact resumption
# ---------------------------------------------------------------------------

RESUME = {
    # a failure before the first checkpoint: restart from the seeded init
    "fault before the first checkpoint": dict(fault_schedule={3: BY_NAME["ConnectionError"]}),
    # no cordon: the newest snapshot, from the RAM cache
    "RAM restore": dict(fault_schedule={13: BY_NAME["ConnectionError"]}),
    # a cordon with no RAM cache: drain the persists, restore from disk
    "disk restore": dict(fault_schedule={13: BY_NAME["ECCError"]}, ram_cache_slots=0),
    "spike rollback": dict(spike_schedule={12 + i: 50.0 for i in range(3)}),
    # a spike with nothing to roll back to: restart from the seeded init, the
    # loader skipping the spike's data from step 0 on (the JAX trainer's
    # init_state drops the skip ranges here; the port applies them)
    "spike before the first checkpoint": dict(
        ckpt_every=15, spike_schedule={9 + i: 50.0 for i in range(3)}),
}


@pytest.mark.parametrize("case", list(RESUME))
def test_resumption_is_exact(case, tmp_path):
    """The supervised run ends with the parameter bits, and the last loss
    recorded for each step, of an uninterrupted run whose loader skips what
    the supervised run's last attempt skipped."""
    trainer, ckpt = _trainer(tmp_path / "supervised", steps=20,
                             **{"ckpt_every": 5, **RESUME[case]})
    report, skips = _run(trainer, ckpt)
    kinds = [e.kind for e in report.events]
    assert report.completed and report.final_step == 20 and len(kinds) == 2, kinds
    event = report.events[0]
    if case == "fault before the first checkpoint":
        assert event.resumed_from == 0
    elif case == "spike rollback":
        assert event.kind == "spike" and skips and event.resumed_from <= 12
    elif case == "spike before the first checkpoint":
        assert event.kind == "spike" and skips and event.resumed_from == 0
    else:
        assert event.kind == "failure" and event.resumed_from == 10
    if case == "disk restore":
        assert not ckpt.ram_cache
    ref, ref_ckpt = _trainer(tmp_path / "uninterrupted", steps=20, ckpt_every=10 ** 9)
    assert ref.job(JobContext(start_step=0, attempt=0, skip_ranges=skips,
                              healthy_nodes=1, resume_extra={})) == 20
    ref_ckpt.close()
    assert [s for s, _ in ref.history] == list(range(1, 21))
    assert dict(trainer.history) == dict(ref.history)
    ours, theirs = tree_leaves(trainer.params), tree_leaves(ref.params)
    assert all(torch.equal(a, b) for a, b in zip(ours, theirs))
    assert int(trainer.opt.step) == int(ref.opt.step) == 20


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_trains_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "smollm-360m",
         "--smoke", "--device", "cpu", "--steps", "8", "--global-batch", "2",
         "--seq-len", "16", "--ckpt-every", "4", "--ckpt-dir", str(tmp_path / "ckpt")],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "done: completed=True final_step=8" in res.stderr
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_00000004", "step_00000008"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without a GPU")
def test_cli_needs_the_card_without_device(monkeypatch, tmp_path):
    monkeypatch.setattr(sys, "argv", ["train", "--smoke", "--steps", "2",
                                      "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main()
