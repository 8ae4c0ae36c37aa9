"""Auto-restart supervisor: run -> fail -> diagnose -> detect -> recover.

This is the orchestrator that stitches the paper's three §6.1 modules into
the pretraining loop:

    job body raises      ->  FailureDiagnosisSystem (rules + agent)
    infra failure        ->  two-round allgather sweep -> cordon nodes
    loss spike           ->  rollback to an *earlier* checkpoint + skip batches
    recoverable          ->  restore last good checkpoint, restart
    non-recoverable      ->  surface to user (counted as manual intervention)

The job body is any callable ``job_fn(ctx) -> final_step`` that raises
``JobFailure`` (with its runtime log) or ``SpikeInterrupt`` (with the
detector's event). ``ctx`` exposes the start step, the skip ranges for the
data loader, and the cordoned-node count so an elastic job can shrink its
mesh. The same supervisor drives both the simulated failure benchmarks and
the real CPU training example.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch.core.ft.checkpoint import CheckpointManager
from repro_torch.core.ft.detection import (DetectionResult, SimulatedFleet,
                                     two_round_detection)
from repro_torch.core.ft.diagnosis import Diagnosis, FailureDiagnosisSystem
from repro_torch.core.ft.spike import SpikeEvent
from repro_torch.utils import logger


class JobFailure(Exception):
    def __init__(self, step: int, log_lines: list[str],
                 truth: Optional[str] = None):
        super().__init__(f"job failed at step {step}")
        self.step = step
        self.log_lines = log_lines
        self.truth = truth            # ground-truth failure name (evaluation)


class SpikeInterrupt(Exception):
    def __init__(self, event: SpikeEvent):
        super().__init__(f"loss spike at step {event.onset_step}")
        self.event = event


@dataclasses.dataclass
class JobContext:
    start_step: int
    attempt: int
    skip_ranges: list[tuple[int, int]]
    healthy_nodes: int
    resume_extra: dict


@dataclasses.dataclass
class RecoveryEvent:
    attempt: int
    kind: str                      # "failure" | "spike" | "done"
    step: int
    diagnosis: Optional[Diagnosis] = None
    detection: Optional[DetectionResult] = None
    resumed_from: Optional[int] = None
    lost_steps: int = 0
    manual: bool = False
    truth: Optional[str] = None


@dataclasses.dataclass
class SupervisorReport:
    completed: bool
    final_step: int
    attempts: int
    events: list[RecoveryEvent]

    @property
    def auto_recoveries(self) -> int:
        return sum(1 for e in self.events
                   if e.kind in ("failure", "spike") and not e.manual)

    @property
    def manual_interventions(self) -> int:
        return sum(1 for e in self.events if e.manual)

    @property
    def lost_steps(self) -> int:
        return sum(e.lost_steps for e in self.events)

    @property
    def diagnosis_accuracy(self) -> float:
        """Fraction of failures whose diagnosed type matches ground truth."""
        scored = [e for e in self.events
                  if e.kind == "failure" and e.truth is not None]
        if not scored:
            return 1.0
        ok = sum(1 for e in scored
                 if e.diagnosis and e.diagnosis.failure == e.truth)
        return ok / len(scored)


class Supervisor:
    """Automatic failure handling around a restartable job body."""

    def __init__(self, ckpt: CheckpointManager,
                 diagnosis: Optional[FailureDiagnosisSystem] = None,
                 fleet: Optional[SimulatedFleet] = None, *,
                 max_attempts: int = 16,
                 on_manual: Optional[Callable[[Diagnosis], None]] = None):
        self.ckpt = ckpt
        self.diagnosis = diagnosis or FailureDiagnosisSystem()
        self.fleet = fleet
        self.max_attempts = max_attempts
        self.on_manual = on_manual     # called when a human must step in

    def run(self, job_fn: Callable[[JobContext], int], *,
            start_step: int = 0) -> SupervisorReport:
        events: list[RecoveryEvent] = []
        skip_ranges: list[tuple[int, int]] = []
        resume_step = start_step
        resume_extra: dict = {}

        for attempt in range(self.max_attempts):
            ctx = JobContext(
                start_step=resume_step, attempt=attempt,
                skip_ranges=list(skip_ranges),
                healthy_nodes=(len(self.fleet.healthy_nodes())
                               if self.fleet else 1),
                resume_extra=dict(resume_extra))
            try:
                final = job_fn(ctx)
                events.append(RecoveryEvent(attempt, "done", final))
                return SupervisorReport(True, final, attempt + 1, events)

            except SpikeInterrupt as s:
                ev = s.event
                resume_step = ev.rollback_step
                skip_ranges.append(ev.skip_range)
                # the job restarts from the *rollback* checkpoint, so its
                # extra state (loader position, scaler, ...) must come from
                # that checkpoint too — not linger from the previous attempt
                resume_extra = self._peek_extra(ev.rollback_step)
                events.append(RecoveryEvent(
                    attempt, "spike", ev.detect_step,
                    resumed_from=ev.rollback_step,
                    lost_steps=max(0, ev.detect_step - ev.rollback_step)))
                logger.info("spike at %d: rollback to %d, skipping data %s",
                            ev.onset_step, ev.rollback_step, ev.skip_range)

            except JobFailure as f:
                diag = self.diagnosis.diagnose(f.log_lines)
                detection = None
                if diag.needs_node_cordon and self.fleet is not None:
                    detection = two_round_detection(
                        self.fleet.healthy_nodes(), self.fleet)
                    self.fleet.cordon(detection.faulty)
                    # once cordoned, the fault no longer fires probes/errors
                    for n in detection.faulty:
                        self.fleet.faulty.discard(n)
                    logger.info("detection: %d probes, faulty=%s",
                                detection.probes, detection.faulty)
                manual = not diag.auto_recoverable
                if manual and self.on_manual is not None:
                    self.on_manual(diag)
                # node loss invalidates that node's RAM cache; a process-level
                # failure can restart from the in-RAM snapshot (fast path)
                if diag.needs_node_cordon:
                    # surviving hosts finish their in-flight background
                    # persists before the restart point is chosen — without
                    # this drain, a snapshot taken just before the failure
                    # may not have landed on disk yet and the job resumes
                    # from a much older step (or from scratch)
                    try:
                        self.ckpt.wait(timeout=60.0)
                    except TimeoutError:
                        logger.warning("persist queue did not drain before "
                                       "restart; resuming from what is on disk")
                    last = self.ckpt.latest_step()
                else:
                    last = self.ckpt.latest_restorable()
                resumed = last if last is not None else start_step
                events.append(RecoveryEvent(
                    attempt, "failure", f.step, diagnosis=diag,
                    detection=detection, resumed_from=resumed,
                    lost_steps=max(0, f.step - resumed), manual=manual,
                    truth=f.truth))
                resume_step = resumed
                if last is not None:
                    resume_extra = self._peek_extra(last)
                logger.info("failure at %d diagnosed %s (%s, manual=%s); "
                            "resume from %d", f.step, diag.failure,
                            diag.source, manual, resumed)

        return SupervisorReport(False, resume_step, self.max_attempts, events)

    def _peek_extra(self, step: int) -> dict:
        if step in self.ckpt.ram_cache:
            return dict(self.ckpt.ram_cache[step][1])
        import json
        import os
        path = os.path.join(self.ckpt.dir, f"step_{step:08d}",
                            "manifest.json")
        try:
            with open(path) as fh:
                return dict(json.load(fh).get("extra", {}))
        except OSError:
            return {}
