"""Fast fault detection (paper §6.1, design 3).

Two-round pairwise-allgather sweep (the DLRover-style screen the paper
adopts):

  Round 1: divide all nodes into 2-node worlds (one world of 3 when the
           count is odd) and run an allgather health probe in each. A failed
           world marks *all* its members as suspects.
  Round 2: pair every suspect with a known-good node and probe again; the
           worlds that fail pinpoint the faulty nodes, which are cordoned.

The probe is abstract (``NodeProbe``): the simulated fleet flips health bits;
a real deployment implements it with a small allgather over
``jax.experimental.multihost_utils`` on the candidate hosts.

Also includes the straggler monitor: per-host step wall-times -> robust
z-score (median/MAD) -> slow hosts feed the same cordon list, so persistent
stragglers are removed at the next elastic restart.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Protocol, Sequence

import numpy as np


class NodeProbe(Protocol):
    def allgather_ok(self, world: Sequence[int]) -> bool:
        """Run an allgather across ``world`` node ids; True iff it passes."""
        ...


# ---------------------------------------------------------------------------
# simulated fleet (the container has no multi-host hardware)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SimulatedFleet:
    """A fleet of nodes with hidden health state and a probe counter."""
    num_nodes: int
    faulty: set[int] = dataclasses.field(default_factory=set)
    cordoned: set[int] = dataclasses.field(default_factory=set)
    probes_run: int = 0

    def healthy_nodes(self) -> list[int]:
        return [n for n in range(self.num_nodes)
                if n not in self.cordoned]

    def allgather_ok(self, world: Sequence[int]) -> bool:
        self.probes_run += 1
        return not any(n in self.faulty for n in world)

    def fail(self, nodes: Iterable[int]) -> None:
        self.faulty.update(nodes)

    def repair(self, nodes: Iterable[int]) -> None:
        for n in nodes:
            self.faulty.discard(n)
            self.cordoned.discard(n)

    def cordon(self, nodes: Iterable[int]) -> None:
        self.cordoned.update(nodes)


# ---------------------------------------------------------------------------
# two-round localization
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DetectionResult:
    faulty: tuple[int, ...]
    suspects_round1: tuple[int, ...]
    probes: int
    rounds: int


def _pair_up(nodes: list[int]) -> list[list[int]]:
    """2-node worlds; odd count -> one world of 3 (paper's rule)."""
    worlds = [list(nodes[i:i + 2]) for i in range(0, len(nodes) - (len(nodes) % 2), 2)]
    if len(nodes) % 2:
        if worlds:
            worlds[-1].append(nodes[-1])
        else:
            worlds = [[nodes[-1]]]
    return worlds


def two_round_detection(nodes: Sequence[int],
                        probe: NodeProbe) -> DetectionResult:
    """Locate faulty nodes with two rounds of pairwise allgather probes."""
    nodes = list(nodes)
    probes = 0

    # round 1: pairwise sweep
    suspects: list[int] = []
    cleared: list[int] = []
    for world in _pair_up(nodes):
        probes += 1
        if probe.allgather_ok(world):
            cleared.extend(world)
        else:
            suspects.extend(world)

    if not suspects:
        return DetectionResult((), (), probes, 1)

    # round 2: re-pair each suspect with a known-good node
    faulty: list[int] = []
    if not cleared:
        # degenerate fleet (everything suspect): probe each node "alone";
        # a single-node allgather still exercises its NIC/GPU path.
        for s in suspects:
            probes += 1
            if not probe.allgather_ok([s]):
                faulty.append(s)
        return DetectionResult(tuple(faulty), tuple(suspects), probes, 2)

    good_cycle = 0
    for s in suspects:
        buddy = cleared[good_cycle % len(cleared)]
        good_cycle += 1
        probes += 1
        if not probe.allgather_ok([s, buddy]):
            faulty.append(s)
    return DetectionResult(tuple(faulty), tuple(suspects), probes, 2)


# ---------------------------------------------------------------------------
# straggler monitor
# ---------------------------------------------------------------------------

class StragglerMonitor:
    """Per-host step-time ring buffers -> robust z-score slow-host flags.

    A host is a straggler when its median step time exceeds the fleet
    median by ``z_threshold`` robust z-scores (MAD-based) for at least
    ``min_samples`` observed steps.
    """

    def __init__(self, hosts: Sequence[int], *, window: int = 32,
                 z_threshold: float = 6.0, min_samples: int = 8):
        self.window = window
        self.z_threshold = z_threshold
        self.min_samples = min_samples
        self.times: dict[int, list[float]] = {h: [] for h in hosts}

    def record(self, host: int, step_time: float) -> None:
        buf = self.times.setdefault(host, [])
        buf.append(step_time)
        if len(buf) > self.window:
            del buf[0]

    def stragglers(self) -> list[int]:
        meds = {h: float(np.median(t)) for h, t in self.times.items()
                if len(t) >= self.min_samples}
        if len(meds) < 3:
            return []
        vals = np.array(list(meds.values()))
        med = float(np.median(vals))
        mad = float(np.median(np.abs(vals - med))) or 1e-9
        out = []
        for h, v in meds.items():
            z = 0.6745 * (v - med) / mad
            if z > self.z_threshold:
                out.append(h)
        return sorted(out)
