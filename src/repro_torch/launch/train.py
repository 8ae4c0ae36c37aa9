"""End-to-end fault-tolerant training: the Trainer and its CLI.

The full §6.1 stack around the port's training loop: the train step
(:func:`repro_torch.train.make_train_step`), the deterministic resumable data
pipeline, asynchronous checkpointing, loss-spike detection with rollback +
data-skip, failure diagnosis and the auto-restart supervisor. The port of
``repro.launch.train``, on one device, on the card unless the caller asks
for the CPU. There is no device mesh yet (ROADMAP Queue 1 item 12): the
model carries its ``ParallelConfig``, and ``--model-axis`` is not ported.

The trainer keeps one state for the whole run: the model's own parameters
and one AdamW state, which the train step updates in place. A restore writes
a checkpoint into them, and a restart from step 0 with nothing to restore
writes the seeded init (:meth:`Trainer.initial_params`) back into them and
zeroes m, v and the step, so that no restart carries on from trained tensors.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --smoke --device cpu --steps 120 --ckpt-every 20 --ckpt-dir build/ckpt
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.config import (ParallelConfig, TrainConfig, get_arch,
                                get_smoke)
from repro_torch.core.ft.checkpoint import CheckpointManager
from repro_torch.core.ft.detection import SimulatedFleet, StragglerMonitor
from repro_torch.core.ft.diagnosis import FailureDiagnosisSystem
from repro_torch.core.ft.spike import SpikeDetector
from repro_torch.core.ft.supervisor import (JobContext, JobFailure,
                                            SpikeInterrupt, Supervisor)
from repro_torch.data import DataConfig, DataLoader, SyntheticLM
from repro_torch.models import Model
from repro_torch.models.spec import init_params
from repro_torch.train import adamw_init, make_train_step
from repro_torch.train.optimizer import AdamState, tree_leaves
from repro_torch.utils import logger


@dataclasses.dataclass
class TrainerState:
    params: object
    opt: AdamState
    loader: DataLoader


class Trainer:
    """Restartable training job body driven by the Supervisor."""

    def __init__(self, model: Model, tcfg: TrainConfig,
                 ckpt: CheckpointManager, *, total_steps: int,
                 ckpt_every: int = 20,
                 fault_schedule: Optional[dict] = None,
                 spike_schedule: Optional[dict] = None,
                 log_every: int = 10,
                 fleet: Optional[SimulatedFleet] = None,
                 host_time_fn=None):
        self.model, self.tcfg = model, tcfg
        self.ckpt = ckpt
        self.total_steps = total_steps
        self.ckpt_every = ckpt_every
        self.fault_schedule = dict(fault_schedule or {})  # step -> FailureType
        self.spike_schedule = dict(spike_schedule or {})  # step -> delta loss
        self.log_every = log_every
        self.detector = SpikeDetector(min_history=8, patience=3,
                                      z_threshold=6.0)
        # straggler mitigation: per-host step times feed the same cordon
        # list the detection kit uses; persistently slow hosts are removed
        # at the next elastic restart. host_time_fn(step) -> {host: seconds}
        # supplies the measurements (real deployments read them from the
        # multihost heartbeat; tests/sims inject them).
        self.fleet = fleet
        self.host_time_fn = host_time_fn
        self.straggler = StragglerMonitor(
            range(fleet.num_nodes) if fleet else [])
        self.history: list[tuple[int, float]] = []
        self.stalls: list[tuple[int, float]] = []    # (step, save_async stall s)
        self.step_fn = make_train_step(model, tcfg)
        self.params = model.params_tree()
        self.opt = adamw_init(self.params)
        data_cfg = DataConfig(vocab_size=model.cfg.vocab_size,
                              seq_len=tcfg.seq_len,
                              global_batch=tcfg.global_batch,
                              seed=tcfg.seed)
        self.dataset = SyntheticLM(data_cfg)
        self._fired: set[int] = set()

    def initial_params(self):
        """The seeded init, a tree shaped like ``model.specs()``."""
        return init_params(self.model.specs(), self.tcfg.seed, self.model.device)

    def init_state(self, skip_ranges=()) -> TrainerState:
        """The seeded init written into the trainer's state, m, v and the
        step zeroed; the loader at data step 0 with ``skip_ranges``."""
        with torch.no_grad():
            for dst, src in zip(tree_leaves(self.params),
                                tree_leaves(self.initial_params())):
                dst.copy_(src)
            for t in tree_leaves(self.opt):
                t.zero_()
        self.model.params_changed()
        return TrainerState(self.params, self.opt,
                            DataLoader(self.dataset, skip_ranges=skip_ranges))

    def _restore(self, step: int, skip_ranges) -> TrainerState:
        (params, opt), extra = self.ckpt.restore(step, (self.params, self.opt))
        self.model.params_changed()
        loader = DataLoader(self.dataset,
                            start_step=int(extra.get("data_step", step)),
                            skip_ranges=[tuple(r) for r in
                                         extra.get("skip_ranges", [])])
        for lo, hi in skip_ranges:
            loader.skip(lo, hi)
        return TrainerState(params, opt, loader)

    def job(self, ctx: JobContext) -> int:
        if ctx.start_step == 0 and self.ckpt.latest_restorable() is None:
            state = self.init_state(ctx.skip_ranges)
        else:
            state = self._restore(ctx.start_step, ctx.skip_ranges)
        self.detector.reset_after_rollback(ctx.start_step)
        step = ctx.start_step
        while step < self.total_steps:
            data_step, batch = state.loader.next()
            batch = {k: torch.from_numpy(v).to(self.model.device)
                     for k, v in batch.items()}
            state.params, state.opt, metrics = self.step_fn(
                state.params, state.opt, batch)
            loss = float(metrics["loss"])
            # injected anomalies (benchmarks / example demos)
            if data_step in self.spike_schedule and not self._skipped(state, data_step):
                loss += self.spike_schedule[data_step]
            step += 1
            self.history.append((step, loss))
            if step % self.log_every == 0:
                logger.info("step %d loss %.4f lr %.2e", step, loss,
                            float(metrics["lr"]))
            ev = self.detector.update(step, loss,
                                      self.ckpt.available_steps() or
                                      list(self.ckpt.ram_cache))
            if ev is not None:
                raise SpikeInterrupt(ev)
            if step % self.ckpt_every == 0:
                stall = self.ckpt.save_async(
                    step, (state.params, state.opt),
                    extra={"data_step": state.loader.step,
                           "skip_ranges": state.loader.skip_ranges})
                self.stalls.append((step, stall))
                logger.debug("ckpt %d stall %.1fms", step, stall * 1e3)
            if self.host_time_fn is not None and self.fleet is not None:
                for host, t in self.host_time_fn(step).items():
                    self.straggler.record(host, t)
                slow = [h for h in self.straggler.stragglers()
                        if h not in self.fleet.cordoned]
                if slow:
                    self.fleet.cordon(slow)
                    logger.info("stragglers cordoned at step %d: %s",
                                step, slow)
            if step in self.fault_schedule and step not in self._fired:
                self._fired.add(step)
                from repro_torch.core.ft.events import generate_log
                ft = self.fault_schedule[step]
                raise JobFailure(step, generate_log(ft, seed=step), truth=ft.name)
        return step

    def _skipped(self, state: TrainerState, data_step: int) -> bool:
        return any(lo <= data_step < hi for lo, hi in state.loader.skip_ranges)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--ckpt-dir", default="build/ckpt")
    ap.add_argument("--device", default=None,
                    help="torch device; the card (cuda) when omitted")
    args = ap.parse_args()

    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    parallel = ParallelConfig(remat="none", moe_impl="dense")
    tcfg = TrainConfig(global_batch=args.global_batch, seq_len=args.seq_len,
                       total_steps=args.steps, warmup_steps=args.steps // 10)
    model = Model(cfg, parallel, device=args.device, seed=tcfg.seed)
    ckpt = CheckpointManager(args.ckpt_dir, keep=4)
    trainer = Trainer(model, tcfg, ckpt,
                      total_steps=args.steps, ckpt_every=args.ckpt_every)
    sup = Supervisor(ckpt, FailureDiagnosisSystem(), SimulatedFleet(8))
    t0 = time.time()
    report = sup.run(trainer.job)
    ckpt.wait()
    ckpt.close()
    losses = [l for _, l in trainer.history]
    logger.info("done: completed=%s final_step=%d attempts=%d "
                "loss %.3f -> %.3f (%.1fs)", report.completed,
                report.final_step, report.attempts, losses[0], losses[-1],
                time.time() - t0)


if __name__ == "__main__":
    main()
