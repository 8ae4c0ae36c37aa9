"""Failure diagnosis system (paper §6.1 Fig. 15).

Pipeline:
  1. Real-time log compression — evolving regex *Filter Rules*, maintained by
     the LLM Log Agent (self-consistency voted); repeated/similar jobs reuse
     the accumulated rules, so filtering gets cheaper over time.
  2. Rule-based diagnosis — regexes learned from previously diagnosed
     incidents, tried first.
  3. On miss: the compressed log is embedded (hashed bag-of-words) into a
     vector store; the Failure Agent retrieves similar past incidents and
     diagnoses the root cause via the LLM; the result is written back as a
     new rule (continuous learning) and a new vector-store entry.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import re
from typing import Optional

import numpy as np

from repro_torch.core.ft.events import BY_NAME, FailureType
from repro_torch.core.ft.log_agent import (FAILURE_AGENT_PROMPT, LOG_AGENT_PROMPT,
                                     LLMClient, OfflineLLM, looks_like_error,
                                     self_consistent, template_of,
                                     template_to_regex)


# ---------------------------------------------------------------------------
# 1. log compression
# ---------------------------------------------------------------------------

class LogCompressor:
    """Filter-rule based compressor; rules evolve via the Log Agent."""

    def __init__(self, client: Optional[LLMClient] = None,
                 segment_lines: int = 200, samples: int = 3):
        self.client = client or OfflineLLM()
        self.rules: list[re.Pattern] = []
        self.segment_lines = segment_lines
        self.samples = samples
        self.stats = {"in_lines": 0, "out_lines": 0, "agent_calls": 0}

    def add_rule(self, regex: str) -> None:
        try:
            pat = re.compile(regex)
        except re.error:
            return
        if pat.pattern not in {r.pattern for r in self.rules}:
            self.rules.append(pat)

    def _filter(self, lines: list[str]) -> list[str]:
        out = []
        for line in lines:
            if any(r.search(line) for r in self.rules):
                continue
            out.append(line)
        return out

    def compress(self, lines: list[str]) -> list[str]:
        """Stream segments through the rules; ask the Log Agent to mine new
        rules for whatever survives; keep error-looking lines."""
        kept: list[str] = []
        self.stats["in_lines"] += len(lines)
        for i in range(0, len(lines), self.segment_lines):
            seg = self._filter(lines[i:i + self.segment_lines])
            if not seg:
                continue
            # if the segment still contains many non-error lines, mine rules
            non_err = [l for l in seg if not looks_like_error(l)]
            if len(non_err) >= 3:
                prompt = LOG_AGENT_PROMPT.format(segment="\n".join(seg))
                reply = self_consistent(self.client, prompt,
                                        samples=self.samples,
                                        key="filter_regexes")
                self.stats["agent_calls"] += 1
                for rx in reply.get("filter_regexes", []) or []:
                    self.add_rule(rx)
                seg = self._filter(seg)
            kept.extend(seg)
        self.stats["out_lines"] += len(kept)
        return kept

    @property
    def compression_ratio(self) -> float:
        if self.stats["out_lines"] == 0:
            return float("inf")
        return self.stats["in_lines"] / self.stats["out_lines"]


# ---------------------------------------------------------------------------
# 2. rule-based diagnosis (learned over time)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Rule:
    pattern: re.Pattern
    failure: str
    priority: int


@dataclasses.dataclass
class Diagnosis:
    failure: str
    category: str
    confidence: float
    source: str              # "rule" | "agent" | "unknown"
    mitigation: str = ""
    root_cause_line: str = ""
    needs_node_cordon: bool = False
    auto_recoverable: bool = True

    @classmethod
    def from_failure_type(cls, ft: FailureType, source: str,
                          confidence: float, line: str = "",
                          mitigation: str = "") -> "Diagnosis":
        return cls(failure=ft.name, category=ft.category,
                   confidence=confidence, source=source,
                   mitigation=mitigation, root_cause_line=line,
                   needs_node_cordon=ft.needs_node_cordon,
                   auto_recoverable=ft.auto_recoverable)


class RuleBasedDiagnoser:
    """Ordered regex rules; highest-priority match wins (root-cause logic:
    a CUDA/NVLink rule outranks the NCCL-timeout symptom it causes)."""

    def __init__(self, seed_rules: Optional[list[tuple[str, str]]] = None):
        self.rules: list[Rule] = []
        for failure, rx in seed_rules or []:
            self.add_rule(failure, rx)

    def add_rule(self, failure: str, regex: str) -> None:
        ft = BY_NAME.get(failure)
        if ft is None:
            return
        try:
            pat = re.compile(regex, re.IGNORECASE)
        except re.error:
            return
        if any(r.pattern.pattern == pat.pattern for r in self.rules):
            return
        self.rules.append(Rule(pat, failure, ft.priority))
        self.rules.sort(key=lambda r: -r.priority)

    def diagnose(self, lines: list[str]) -> Optional[Diagnosis]:
        for rule in self.rules:                      # priority order
            for line in lines:
                if rule.pattern.search(line):
                    ft = BY_NAME[rule.failure]
                    return Diagnosis.from_failure_type(
                        ft, "rule", 0.95, line,
                        mitigation="(cached rule)")
        return None


# -- recovery-policy taxonomy (consumed by repro.cluster.replay) ------------
#
# The replay engine collapses a fine-grained Diagnosis onto three recovery
# verdicts: a node is at fault (cordon it, or shrink the job elastically off
# it), the fault is transient (restart in place from the last checkpoint
# without giving up the allocation), or a human must fix something (the job
# is resubmitted).
VERDICT_HARDWARE, VERDICT_TRANSIENT, VERDICT_USER = \
    "hardware", "transient", "user"


def verdict_class(diag: Diagnosis) -> str:
    """Map a :class:`Diagnosis` onto the replay recovery taxonomy."""
    if diag.needs_node_cordon:
        return VERDICT_HARDWARE
    if diag.auto_recoverable and diag.failure != "Unknown":
        return VERDICT_TRANSIENT
    return VERDICT_USER


DEFAULT_SEED_RULES: list[tuple[str, str]] = [
    ("OutOfMemoryError", r"OutOfMemoryError|RESOURCE_EXHAUSTED"),
    ("FileNotFoundError", r"FileNotFoundError"),
    ("ImportError", r"ImportError: cannot import"),
]

_INFRA_HINTS = ("nvlink", "cuda error", "ecc", "nccl", "infiniband",
                "ibv_", "rdma", "xid ", "slurmstepd", "kubelet",
                "unexpectedly rebooted", "notready")


def _infra_signature(lines: list[str]) -> bool:
    return any(h in l.lower() for l in lines for h in _INFRA_HINTS)


# ---------------------------------------------------------------------------
# 3. vector store + failure agent
# ---------------------------------------------------------------------------

def embed(lines: list[str], dim: int = 512) -> np.ndarray:
    """Hashed bag-of-words embedding of a compressed log (unit norm)."""
    v = np.zeros(dim, np.float32)
    for line in lines:
        for tok in re.split(r"[^A-Za-z_]+", template_of(line).lower()):
            if len(tok) < 3:
                continue
            h = int(hashlib.md5(tok.encode()).hexdigest()[:8], 16)
            v[h % dim] += 1.0
    n = np.linalg.norm(v)
    return v / n if n else v


class VectorStore:
    def __init__(self, dim: int = 512):
        self.dim = dim
        self.vectors: list[np.ndarray] = []
        self.payloads: list[dict] = []

    def add(self, lines: list[str], payload: dict) -> None:
        self.vectors.append(embed(lines, self.dim))
        self.payloads.append(payload)

    def query(self, lines: list[str], k: int = 3) -> list[tuple[float, dict]]:
        if not self.vectors:
            return []
        q = embed(lines, self.dim)
        sims = np.stack(self.vectors) @ q
        idx = np.argsort(-sims)[:k]
        return [(float(sims[i]), self.payloads[i]) for i in idx]


class FailureDiagnosisSystem:
    """The full Fig.-15 pipeline; the framework entry point."""

    def __init__(self, client: Optional[LLMClient] = None,
                 seed_rules: Optional[list[tuple[str, str]]] = None,
                 samples: int = 3):
        self.client = client or OfflineLLM()
        self.compressor = LogCompressor(self.client)
        self.rules = RuleBasedDiagnoser(
            DEFAULT_SEED_RULES if seed_rules is None else seed_rules)
        self.store = VectorStore()
        self.samples = samples
        self.stats = {"rule_hits": 0, "agent_hits": 0, "unknown": 0}

    def diagnose(self, raw_lines: list[str]) -> Diagnosis:
        compressed = self.compressor.compress(raw_lines)
        error_lines = [l for l in compressed if looks_like_error(l)] or compressed
        hit = self.rules.diagnose(error_lines)
        if hit is not None:
            # Cascade guard (the paper's motivating case): a learned
            # low-priority framework/script rule can match a *symptom* line
            # while the root cause is an infrastructure fault. If the log
            # carries infra signatures the low-priority rule can't explain,
            # defer to the agent.
            ft = BY_NAME[hit.failure]
            if ft.priority >= 50 or not _infra_signature(error_lines):
                self.stats["rule_hits"] += 1
                return hit
        # agent path: retrieve similar incidents, prompt, vote
        retrieved = self.store.query(error_lines, k=3)
        taxonomy = ", ".join(f"{f.name}: {f.category}"
                             for f in BY_NAME.values())
        prompt = FAILURE_AGENT_PROMPT.format(
            taxonomy=taxonomy,
            retrieved=json.dumps([p for _, p in retrieved]),
            log="\n".join(error_lines[-120:]))
        reply = self_consistent(self.client, prompt, samples=self.samples,
                                key="failure")
        name = reply.get("failure", "Unknown")
        ft = BY_NAME.get(name)
        if ft is None:
            self.stats["unknown"] += 1
            return Diagnosis("Unknown", "Unknown", 0.0, "unknown",
                             mitigation="escalate to on-call",
                             auto_recoverable=False)
        self.stats["agent_hits"] += 1
        diag = Diagnosis.from_failure_type(
            ft, "agent", float(reply.get("confidence", 0.5)),
            reply.get("root_cause_line", ""),
            reply.get("mitigation", ""))
        # continuous learning: write back a rule + a vector-store entry
        line = diag.root_cause_line
        if line:
            self.rules.add_rule(name, template_to_regex(template_of(line)))
        self.store.add(error_lines, {"failure": name,
                                     "mitigation": diag.mitigation})
        return diag
