"""LLM-involved log analysis (paper §6.1, design 2 — Log Agent).

Architecture is faithful to the paper: agents talk to an ``LLMClient``
through *prompts* and parse structured JSON replies, with self-consistency
voting across multiple samples. The repo ships an offline deterministic
client (``OfflineLLM``) implementing the same contract with a Drain-style
log-template miner + keyword scorer, so everything runs hermetically; a real
GPT-4/InternLM endpoint can be dropped in by implementing ``complete()``.
"""
from __future__ import annotations

import collections
import json
import random
import re
from typing import Optional, Protocol

# ---------------------------------------------------------------------------
# LLM client interface
# ---------------------------------------------------------------------------


class LLMClient(Protocol):
    def complete(self, prompt: str, *, seed: int = 0) -> str:
        """Return the model's reply for ``prompt`` (JSON per our prompts)."""
        ...


LOG_AGENT_PROMPT = """You are a Log Agent for LLM pretraining jobs.
Given the log segment below, identify lines that follow fixed, repeating
patterns (metric records, init banners, debug output) and propose regular
expressions that match ONLY those regular lines so they can be filtered out.
Also list any lines that look like errors. Reply with JSON:
{{"filter_regexes": [...], "error_lines": [...]}}

LOG SEGMENT:
{segment}
"""

FAILURE_AGENT_PROMPT = """You are a Failure Agent diagnosing an LLM
pretraining job interruption. Candidate failure types (name: category):
{taxonomy}

Similar past incidents (may be empty):
{retrieved}

Compressed error log:
{log}

Identify the single ROOT CAUSE (secondary symptoms like NCCL timeouts often
follow a GPU/NVLink fault). Reply with JSON:
{{"failure": "<name>", "category": "<Infrastructure|Framework|Script>",
  "confidence": <0..1>, "root_cause_line": "<line>",
  "mitigation": "<one sentence>"}}
"""


# ---------------------------------------------------------------------------
# offline deterministic "LLM": template miner + keyword scorer
# ---------------------------------------------------------------------------

_NUM = re.compile(r"(?<![\w.])\d[\d.]*")
_HEX = re.compile(r"0x[0-9a-fA-F]+")
_PATH = re.compile(r"(/[\w.\-]+)+")
_ERROR_HINTS = ("error", "exception", "traceback", "failed", "fatal", "killed",
                "timeout", "assert", "notready", "refused", "denied",
                "exceeded", "not defined", "no such file", "out of memory",
                "invalid", "unable")


def template_of(line: str) -> str:
    """Drain-lite: normalize volatile fields to wildcards."""
    t = _HEX.sub("<*>", line)
    t = _PATH.sub("<P>", t)
    t = _NUM.sub("<#>", t)
    return t.strip()


def looks_like_error(line: str) -> bool:
    low = line.lower()
    return any(h in low for h in _ERROR_HINTS)


def template_to_regex(template: str) -> str:
    parts = re.split(r"(<\*>|<#>|<P>)", template)
    out = []
    for p in parts:
        if p == "<#>":
            out.append(r"\d[\d.]*")
        elif p == "<*>":
            out.append(r"0x[0-9a-fA-F]+")
        elif p == "<P>":
            out.append(r"(?:/[\w.\-]+)+")
        else:
            out.append(re.escape(p))
    return "".join(out)


class OfflineLLM:
    """Deterministic stand-in honoring the LLMClient prompt/JSON contract."""

    def __init__(self, min_template_count: int = 3):
        self.min_template_count = min_template_count

    def complete(self, prompt: str, *, seed: int = 0) -> str:
        if prompt.startswith("You are a Log Agent"):
            return self._log_agent(prompt, seed)
        if prompt.startswith("You are a Failure Agent"):
            return self._failure_agent(prompt, seed)
        return "{}"

    # -- log agent: mine repeating templates -------------------------------

    def _log_agent(self, prompt: str, seed: int) -> str:
        segment = prompt.split("LOG SEGMENT:\n", 1)[1]
        lines = [l for l in segment.splitlines() if l.strip()]
        counts: dict[str, int] = collections.Counter()
        errors = []
        for line in lines:
            if looks_like_error(line):
                errors.append(line)
            else:
                counts[template_of(line)] += 1
        regexes = [template_to_regex(t) for t, c in counts.items()
                   if c >= self.min_template_count]
        # emulate sampling temperature: a seed-dependent subset ordering
        rng = random.Random(seed)
        rng.shuffle(regexes)
        return json.dumps({"filter_regexes": regexes,
                           "error_lines": errors[:50]})

    # -- failure agent: score taxonomy keywords against the log ------------

    def _failure_agent(self, prompt: str, seed: int) -> str:
        from repro_torch.core.ft.events import TABLE3
        log = prompt.split("Compressed error log:\n", 1)[1]
        log = log.split("Identify the single ROOT CAUSE", 1)[0]
        lines = [l for l in log.splitlines() if l.strip()]
        # the scoring scan is the §6.1 pipeline's hot loop: lowercase each
        # line once (it used to be lowered per signature token) and read
        # template signatures from the module cache — the scores are
        # unchanged, just not recomputed per (template, line, token)
        lower = [l.lower() for l in lines]
        best, best_score, best_line = None, -1.0, ""
        for ft in TABLE3:
            score, line_hit = 0.0, ""
            for tmpl in ft.templates:
                sig = _signature(tmpl)
                n_sig = max(len(sig), 1)
                for line, ll in zip(lines, lower):
                    hit = sum(1 for s in sig if s in ll)
                    frac = hit / n_sig
                    if frac >= 0.6:
                        sc = frac * (1.0 + ft.priority / 100.0)
                        if sc > score:
                            score, line_hit = sc, line
            # tiny seed jitter models LLM sampling variance
            score += _jitter(seed, ft.name)
            if score > best_score:
                best, best_score, best_line = ft, score, line_hit
        if best is None or best_score < 0.3:
            return json.dumps({"failure": "Unknown", "category": "Unknown",
                               "confidence": 0.0, "root_cause_line": "",
                               "mitigation": "escalate to on-call"})
        return json.dumps({
            "failure": best.name, "category": best.category,
            "confidence": min(1.0, best_score / 2.0 + 0.5),
            "root_cause_line": best_line,
            "mitigation": _mitigation(best),
        })


_SIG_CACHE: dict = {}
_JITTER_CACHE: dict = {}


def _signature(template: str) -> list[str]:
    """Distinctive lowercase keywords of a failure template (memoized —
    the agent re-scores the same fixed taxonomy on every call)."""
    sig = _SIG_CACHE.get(template)
    if sig is None:
        t = template.replace("{d}", " ").replace("{w}", " ").lower()
        sig = _SIG_CACHE[template] = \
            [w for w in re.split(r"[^a-z_]+", t) if len(w) >= 4][:8]
    return sig


def _jitter(seed: int, name: str) -> float:
    """The agent's deterministic per-(seed, failure-type) sampling jitter;
    memoized because seeding a fresh ``random.Random`` per score is ~100x
    the cost of the draw it produces."""
    key = (seed, name)
    v = _JITTER_CACHE.get(key)
    if v is None:
        v = _JITTER_CACHE[key] = \
            random.Random(f"{seed}:{name}").random() * 0.01
    return v


def _mitigation(ft) -> str:
    if ft.needs_node_cordon:
        return ("run two-round NCCL sweep, cordon faulty node(s), "
                "auto-restart from last checkpoint")
    if ft.category == "Infrastructure":
        return "retry with backoff; check auxiliary service endpoints"
    if ft.auto_recoverable:
        return "auto-restart from last checkpoint"
    return "surface to user: fix configuration/script and resubmit"


# ---------------------------------------------------------------------------
# self-consistency voting (paper: process segments multiple times + vote)
# ---------------------------------------------------------------------------

def self_consistent(client: LLMClient, prompt: str, *, samples: int = 3,
                    key: str) -> dict:
    """Sample ``complete`` several times; majority-vote on ``key``."""
    replies = []
    for s in range(samples):
        try:
            replies.append(json.loads(client.complete(prompt, seed=s)))
        except (json.JSONDecodeError, KeyError):
            continue
    if not replies:
        return {}
    votes = collections.Counter()
    for r in replies:
        v = r.get(key)
        votes[json.dumps(v, sort_keys=True) if isinstance(v, (list, dict))
              else v] += 1
    winner, _ = votes.most_common(1)[0]
    for r in replies:
        v = r.get(key)
        v_norm = (json.dumps(v, sort_keys=True)
                  if isinstance(v, (list, dict)) else v)
        if v_norm == winner:
            return r
    return replies[0]
