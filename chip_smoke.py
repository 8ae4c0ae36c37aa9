"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

  python3 chip_smoke.py

Builds the port's kernels from the sources in this checkout (one ``nvcc``
per CUDA source, all started together), holds each one against its plain
PyTorch version on the card (the flash-attention and RMSNorm backward
kernels too, each with a negative control; the flash forward at head dims
64, 80, 128 and 192, its LSE entry at 80 and 192 too, and that the backward
at 80 and 192 raises before anything launches; RMSNorm at every served
width), then drives four paths at full width and depth (random weights from
a seed):

  * serving, through ``repro_torch.launch.serve.ServeSession``: smollm-360m
    (flash attention at head dim 64, RMSNorm), mamba2-1.3b (SSD scan,
    RMSNorm), h2o-danube-1.8b (flash attention at head dim 80 with its
    4096 window, RMSNorm) and deepseek-v2-lite-16b cut to 8 layers (MLA:
    flash attention at head dim 192 in prefill, the absorbed-weight decode;
    MoE with routed and shared experts; RMSNorm at 2048 and 512). For each
    it checks the launch counts, the token stream, the cache against a full
    forward (danube also across its window: a 6144-token prompt; deepseek
    with its routing flips counted, each a near-tie), and the card against
    the CPU; for deepseek also the gathered MoE decode against the dense;
  * training, through ``repro_torch.train.make_train_step``: 8 AdamW steps
    of smollm-360m, 8 x 2048 tokens in 2 microbatches (flash attention and
    RMSNorm forward and backward). It checks the launches of every step,
    finite losses, a bit-exact replay of a step from a saved state, one step
    of a 2-layer model on the card against the CPU, and remat against none;
  * supervised training, through ``repro_torch.launch.train.Trainer`` under
    the §6.1 ``Supervisor``: 16 steps of the same model and batches through
    a ConnectionError, a loss spike and an ECCError, with checkpoints of the
    4.34 GB state under build/ (16 GB free needed; removed at the end). It
    checks the events and their resume points, the launches of every step
    executed, and that an uninterrupted run skipping the same data ends with
    the same losses and bits; it times save_async's stall, save_sync and
    restores from the RAM cache and from disk.

It prints:

  * the card's name and power limit (``nvidia-smi``), the build time, and
    per CUDA kernel its registers, shared memory and spills (``nvcc -Xptxas
    -v``) and counts of the SASS opcodes that show its design (wgmma, TMA,
    mbarrier, mma.sync, cp.async, ldmatrix; ``cuobjdump -sass``),
  * one line per check, the wall time of each phase, the serving
    sessions' build time and peak memory, the end-to-end prefill/decode
    tokens/s (median of warm repeats), the train step's wall, tokens/s and
    peak memory, a
    torch.profiler breakdown of one prefill, eight decode steps and one
    train step (device busy time, launches, top kernels), and the
    supervised run's events, checkpoint times and walls,
  * a JSON line ``{"end_to_end": {path: ...}}``,
  * a JSON line ``{"kernels": [...]}`` with each kernel's launches on the
    paths (``launches``, their sum, and ``launches_by_path``), error, time,
    plain time, bound and library time (the flash forward's at head dim 80
    under ``d80``, at 192 as its own row ``flash_attention_d192`` with the
    deepseek path's launches; the RMSNorm forward's at danube's width under
    ``d2560`` and at MLA's kv_norm under ``d512``),
  * last, ``{"ok": true, "device": {...}}``.

Exits non-zero, with no result line, if there is no GPU, if the port's
package is not beside this file, or if any check fails.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and operations/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}

# Prompt batch and decode length of the serving paths; warm timed repeats.
BATCH, PROMPT, GEN = 4, 1024, 32
REPEATS = 5
# The train path: global batch x sequence, microbatch rows, optimizer steps,
# and the step replayed from its saved state.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MB, TRAIN_STEPS = 8, 2048, 4, 8
REPLAY_STEP = 6


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    print(("PASS " if cond else "FAIL ") + what, flush=True)
    if not cond:
        raise CheckFailed(what)


def time_ms(fn, iters: int = 20, warmup: int = 3, rounds: int = 5,
            sleep_per_iter: int = 200_000) -> float:
    """Device time per call: the median over ``rounds`` of CUDA events
    around ``iters`` calls (one round alone has read 20% high on a kernel of
    60 us).

    A sleep kernel of ``sleep_per_iter`` cycles per call first keeps the
    stream busy while the host enqueues the calls, so the events time the
    calls back to back and not the host's launch overhead. A call with much
    host work (an autograd backward) needs a longer sleep than the default
    ~0.1 ms per call."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(rounds):
        torch.cuda._sleep(iters * sleep_per_iter)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[len(times) // 2]


@contextlib.contextmanager
def phase(name: str):
    """Prints the phase's wall time when it ends (not when it fails)."""
    t0 = time.perf_counter()
    yield
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# what was built
# ---------------------------------------------------------------------------

# SASS opcodes that show the design in the compiled code: wgmma (HGMMA),
# mma.sync (HMMA), TMA loads (UTMALDG), mbarrier operations (SYNCS), cp.async
# (LDGSTS), ldmatrix (LDSM); and the ones each library must contain
SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "SYNCS", "LDGSTS", "LDSM")
SASS_REQUIRED = {"flash_attention": ("HGMMA", "UTMALDG", "SYNCS"),
                 "flash_attention_bwd": ("HGMMA", "UTMALDG", "SYNCS"),
                 "ssd": ("HMMA", "LDGSTS")}


def report_build() -> None:
    """Per kernel of each CUDA source: registers, shared memory and spills as
    ``nvcc -Xptxas -v`` printed them, and counts of the SASS opcodes above
    (``cuobjdump -sass``), and per wgmma kernel (each head dim apart) its
    HGMMA count. Fails if a library lacks an opcode its design needs, or a
    wgmma kernel issues no HGMMA."""
    import re
    import shutil
    from repro_torch.kernels import build
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name in build.SOURCES:
        kernels, cur = [], None
        for line in build.build_log(name).splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                cur = {"fn": m.group(1), "regs": "?", "smem": "0", "spill": "?"}
                kernels.append(cur)
            elif cur is not None and "spill stores" in line:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                cur["spill"] = f"{m.group(1)}/{m.group(2)}" if m else "?"
            elif cur is not None and "Used" in line:
                m = re.search(r"Used (\d+) registers", line)
                cur["regs"] = m.group(1) if m else "?"
                m = re.search(r"(\d+) bytes smem", line)
                cur["smem"] = m.group(1) if m else "0"
        for k in kernels:
            print(f"ptxas {name}: {k['fn'][:100]}: {k['regs']} registers, {k['smem']} bytes "
                  f"static smem, spill stores/loads {k['spill']} bytes", flush=True)
        fwd192 = [k for k in kernels if "flash_fwd_wgmmaILi192E" in k["fn"]]
        if name == "flash_attention":
            check(len(fwd192) == 2 and all(k["spill"] == "0/0" for k in fwd192),
                  f"{name}: both D = 192 wgmma kernels (with and without LSE) spill "
                  f"nothing ({', '.join(k['regs'] + ' registers' for k in fwd192)})")
        sass = subprocess.run([cuobjdump, "-sass", str(build.library(name))],
                              capture_output=True, text=True, timeout=300).stdout
        counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in SASS_OPS}
        print(f"sass {name}: " + ", ".join(f"{op} {n}" for op, n in counts.items()),
              flush=True)
        check(all(counts[op] > 0 for op in SASS_REQUIRED[name]),
              f"{name}: the compiled library contains "
              f"{', '.join(SASS_REQUIRED[name])}")
        # every kernel named *_wgmma<D, flag>, each instantiation apart (the
        # head dims among them), issues HGMMA
        wgmma = {}
        for fn in sass.split("Function : ")[1:]:
            m = re.search(r"([a-z_]+_wgmma)ILi(\d+)ELb(\d)E", fn.split("\n", 1)[0])
            if m:
                key = f"{m.group(1)}<{m.group(2)}, {bool(int(m.group(3)))}>"
                wgmma[key] = len(re.findall(r"\bHGMMA\b", fn))
        if "HGMMA" in SASS_REQUIRED[name]:
            print(f"sass {name} HGMMA by kernel: "
                  + ", ".join(f"{k} {n}" for k, n in sorted(wgmma.items())), flush=True)
            check(bool(wgmma) and all(n > 0 for n in wgmma.values()),
                  f"{name}: each of its {len(wgmma)} wgmma kernels issues HGMMA")


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def _attn_inputs(torch, g, B, Sq, Skv, H, KV, D, dtype, *, strided=False):
    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(dtype)
    if strided:   # q read through a wider tensor: strides, not a copy
        q = rnd(B, Sq, H, 2 * D)[..., :D]
    else:
        q = rnd(B, Sq, H, D)
    return q, rnd(B, Skv, KV, D), rnd(B, Skv, KV, D, std=0.5)


# bf16 outputs are held per element, and also to max-abs <= 2e-2 overall.
# Both sides round an fp32 value to bf16 once, so they may land one ulp apart,
# and one ulp is at most 2**-7 |ref|: the per-element limit starts at twice
# that, 2**-6 |ref|. An error that is small beside the output's own size, as
# a misweighted kv tile in a late row is, fails it where 2e-2 does not.
BF16_RTOL = 2.0 ** -6
BF16_MAX_ABS = 2e-2


def excess(out, ref, limit) -> tuple[float, float]:
    """(max |out - ref|, max |out - ref| / limit): every element is inside
    its limit when the second is <= 1. An exact match counts as 0 even where
    the limit is 0; a NaN anywhere makes both NaN, which fails."""
    import torch
    d = (out.float() - ref.float()).abs()
    ratio = torch.where(d == 0, torch.zeros_like(d), d / limit)
    return d.max().item(), ratio.max().item()


def _flash_limit(torch, q, k, v, qp, kp, ref, kw):
    """The per-element limit of check_flash and what it says (see there)."""
    from repro_torch.kernels.flash_attention import flash_attention_ref
    if q.dtype == torch.float32:
        return 1e-4, "max_abs <= 1e-4"
    abs_v = flash_attention_ref(q, k, v.abs(), qp, kp, **kw).float()
    return (BF16_RTOL * ref.float().abs() + 2.0 ** -8 * abs_v,
            "|d| <= 2**-6 |ref| + 2**-8 attn(|v|) and max_abs <= 2e-2")


def _flash_worst(torch, out, ref, limit) -> tuple[float, float]:
    err, worst = excess(out, ref, limit)
    if out.dtype == torch.bfloat16:
        worst = max(worst, err / BF16_MAX_ABS)
    return err, worst


def check_flash(torch) -> list:
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_attention_with_lse)
    from repro_torch.models.attention import _mask

    g = torch.Generator(device="cuda").manual_seed(0)
    # fp32: max-abs <= 1e-4; the two sides differ only by summation order
    # (~1e-6). bf16, per element: |out - ref| <= 2**-6 |ref| + 2**-8 A, where
    # A is the plain attention of |v|. The kernel rounds P to bf16 before the
    # PV product (as FlashAttention-2 does; the Pallas body keeps P in fp32),
    # a relative error of at most 2**-8 per term, so before its last rounding
    # it is within 2**-8 * sum(p |v|) / l = 2**-8 A of the plain version. The
    # limit holds for any data, and in late rows, whose outputs are small, it
    # is far below 2e-2: a far kv tile dropped or misweighted fails it there.
    # Every case but the timed ones (the model's contiguous layout) reads q
    # through strides. The D = 80 and D = 192 cases also run the LSE entry:
    # its output must equal the serving entry's, its lse the plain version's
    # within 1e-4 (fp32 on both sides; ex2.approx and summation order, ~1e-6
    # of a value of ~10), +inf in the same rows.
    cases = [
        # name, B, Sq, Skv, H, KV, D, dtype, causal, window, softcap
        ("main", BATCH, PROMPT, PROMPT, 15, 5, 64, torch.bfloat16, True, 0, 0.0),
        ("ragged", 2, 33, 130, 4, 1, 64, torch.bfloat16, True, 0, 0.0),
        ("window24", 2, 200, 200, 15, 5, 64, torch.bfloat16, True, 24, 0.0),
        ("softcap30", 2, 200, 200, 15, 5, 64, torch.bfloat16, True, 0, 30.0),
        ("noncausal", 2, 96, 160, 6, 3, 64, torch.bfloat16, False, 0, 0.0),
        ("d128", 2, 300, 300, 8, 2, 128, torch.bfloat16, True, 0, 0.0),
        ("fp32", 2, 257, 257, 15, 5, 64, torch.float32, True, 0, 0.0),
        ("fp32_masked", 1, 70, 150, 4, 2, 128, torch.float32, True, 0, 0.0),
        # edge cases of the tile classes (empty / full / partial by position)
        ("single_tile", 1, 64, 64, 1, 1, 64, torch.bfloat16, True, 0, 0.0),
        ("tail_offset", 2, 200, 1000, 15, 5, 64, torch.bfloat16, True, 0, 0.0),
        ("per_batch_pos", 3, 150, 300, 15, 5, 64, torch.bfloat16, True, 0, 0.0),
        ("bf16_masked", 1, 70, 150, 4, 2, 128, torch.bfloat16, True, 0, 0.0),
        ("d128_window24", 2, 300, 300, 8, 2, 128, torch.bfloat16, True, 24, 0.0),
        # head dim 80: h2o-danube-1.8b's prefill shape, then the edge cases
        ("danube", BATCH, PROMPT, PROMPT, 32, 8, 80, torch.bfloat16, True, 4096, 0.0),
        ("d80_ragged", 2, 33, 130, 4, 1, 80, torch.bfloat16, True, 0, 0.0),
        ("d80_window24", 2, 200, 200, 32, 8, 80, torch.bfloat16, True, 24, 0.0),
        ("d80_softcap30", 2, 200, 200, 32, 8, 80, torch.bfloat16, True, 0, 30.0),
        ("d80_noncausal", 2, 96, 160, 8, 2, 80, torch.bfloat16, False, 0, 0.0),
        ("d80_fp32", 2, 257, 257, 32, 8, 80, torch.float32, True, 0, 0.0),
        ("d80_fp32_masked", 1, 70, 150, 4, 2, 80, torch.float32, True, 0, 0.0),
        ("d80_bf16_masked", 1, 70, 150, 4, 2, 80, torch.bfloat16, True, 0, 0.0),
        ("d80_per_batch_pos", 3, 150, 300, 32, 8, 80, torch.bfloat16, True, 0, 0.0),
        # head dim 192: deepseek-v2-lite-16b's MLA prefill shape (qk 128 + 64,
        # v padded to 192), in bf16 and fp32, then the edge cases
        ("deepseek", BATCH, PROMPT, PROMPT, 16, 16, 192, torch.bfloat16, True, 0, 0.0),
        ("d192_fp32_deepseek", BATCH, PROMPT, PROMPT, 16, 16, 192, torch.float32, True, 0,
         0.0),
        ("d192_ragged", 2, 33, 130, 4, 1, 192, torch.bfloat16, True, 0, 0.0),
        ("d192_fp32_ragged", 2, 33, 130, 4, 1, 192, torch.float32, True, 0, 0.0),
        ("d192_bf16_masked", 1, 70, 150, 4, 2, 192, torch.bfloat16, True, 0, 0.0),
        ("d192_fp32_masked", 1, 70, 150, 4, 2, 192, torch.float32, True, 0, 0.0),
        ("d192_window24", 2, 200, 200, 16, 16, 192, torch.bfloat16, True, 24, 0.0),
        ("d192_noncausal", 2, 96, 160, 8, 2, 192, torch.bfloat16, False, 0, 0.0),
        ("d192_per_batch_pos", 3, 150, 300, 16, 16, 192, torch.bfloat16, True, 0, 0.0),
    ]
    timed_cases = ("main", "danube", "deepseek")
    rows = []
    for name, B, Sq, Skv, H, KV, D, dtype, causal, window, softcap in cases:
        q, k, v = _attn_inputs(torch, g, B, Sq, Skv, H, KV, D, dtype,
                               strided=name not in timed_cases)
        off = max(Skv - Sq, 0)          # queries sit at the tail of the keys
        qp = torch.arange(off, off + Sq, dtype=torch.int32, device="cuda")
        kp = torch.arange(Skv, dtype=torch.int32, device="cuda")
        if name.endswith("_masked"):    # empty slots and fully masked rows
            kp = kp + 10
            kp[-40:] = -1
            qp = torch.arange(Sq, dtype=torch.int32, device="cuda") - 5
        qp, kp = qp.expand(B, Sq), kp.expand(B, Skv)
        if name.endswith("per_batch_pos"):   # row 1's keys 37 later, row 2's queries 50 earlier
            kp = kp + torch.tensor([0, 37, 0], dtype=torch.int32, device="cuda")[:, None]
            qp = qp - torch.tensor([0, 0, 50], dtype=torch.int32, device="cuda")[:, None]
        kw = dict(causal=causal, window=window, softcap=softcap)
        out = flash_attention(q, k, v, qp, kp, **kw)
        ref, ref_lse = flash_attention_ref(q, k, v, qp, kp, return_lse=True, **kw)
        limit, what = _flash_limit(torch, q, k, v, qp, kp, ref, kw)
        err, worst = _flash_worst(torch, out, ref, limit)
        check(out.dtype == q.dtype and out.shape == q.shape
              and bool(torch.isfinite(out).all()) and worst <= 1.0,
              f"flash_attention {name}: max_abs_err {err:.3e}, worst |d|/limit "
              f"{worst:.3f} <= 1 ({what})")
        if name.endswith("_masked"):
            dead = out[:, :10].abs().max().item()   # q_pos < 10: nothing visible
            check(dead == 0.0, f"flash_attention fully masked rows are 0 ({dead})")
        if D in (80, 192):
            out_l, lse = flash_attention_with_lse(q, k, v, qp, kp, **kw)
            inf_k, inf_r = torch.isinf(lse), torch.isinf(ref_lse)
            lse_err = (lse[~inf_r] - ref_lse[~inf_r]).abs().max().item()
            check(torch.equal(out_l, out) and torch.equal(inf_k, inf_r)
                  and bool((lse[inf_k] > 0).all()) and lse_err <= 1e-4,
                  f"flash_attention LSE entry {name}: output equal to the serving "
                  f"entry's, lse max_abs_err {lse_err:.3e} <= 1e-4, +inf in the same "
                  f"{int(inf_r.sum())} rows")
        if name not in timed_cases:
            continue
        ms = time_ms(lambda: flash_attention(q, k, v, qp, kp, **kw))
        plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, qp, kp, **kw), iters=5,
                           rounds=3)
        # library: SDPA on the same inputs, held to the kernel's limits
        # first (it takes head dims up to 256). The window does not bite at
        # these lengths (S = 1024 < 4096), so is_causal is the same function.
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library = lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)  # noqa: E731
        lerr, lworst = _flash_worst(torch, library().transpose(1, 2), ref, limit)
        check(lworst <= 1.0, f"SDPA {name}: max_abs_err {lerr:.3e}, worst |d|/limit "
                             f"{lworst:.3f} <= 1 (the kernel's limits)")
        lib_ms = time_ms(library)
        # the work these inputs need: 4*D operations per visible (q, kv)
        # pair and head (QK^T and PV); each input read once, output written once
        pairs = _mask(qp[:, :, None], kp[:, None, :], window, causal).sum().item()
        ops = 4 * D * H * pairs
        nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, out, qp, kp))
        bound = max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS["bfloat16"]) * 1e3
        by = "operations" if ops / PEAK_OPS["bfloat16"] > nbytes / HBM_BYTES_PER_S else "bytes"
        shape = (f"B={B} S={Sq} H={H} KV={KV} D={D} bf16 causal"
                 + (f" window {window}" if window else ""))
        print(f"flash_attention {name} ({shape}): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound:.4f} ms ({by}; "
              f"{ops:.4e} ops, {nbytes} bytes; {100 * bound / ms:.1f}% of it)", flush=True)
        timed = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}
        src = {"route": "cuda",
               "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
               "replaces": "src/repro/kernels/flash_attention/kernel.py:92"}
        if name == "main":              # deepseek's D = 192 launches go to their own row
            rows.append({"name": "flash_attention", **src, **timed,
                         "paths": (*ARCHS, TRAIN_PATH, SUPERVISED_PATH)})
        elif name == "danube":          # the D = 80 kernel at danube's shape
            rows[0]["d80"] = {"shape": shape, **timed}
        else:                           # the D = 192 kernel at deepseek's shape
            rows.append({"name": "flash_attention_d192", **src, "shape": shape, **timed,
                         "counter": "flash_attention", "paths": (DEEPSEEK_PATH,)})
    return rows


def check_flash_backward_raises(torch) -> None:
    """The backward kernel has no head dim 80 or 192 (ROADMAP Queue 2 item
    A): at each, the backward entry raises, and so does the autograd path,
    before the forward launches anything."""
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_bwd
    g = torch.Generator(device="cuda").manual_seed(7)
    for D in (80, 192):
        q, k, v = _attn_inputs(torch, g, 2, 64, 64, 4, 2, D, torch.bfloat16)
        pos = torch.arange(64, dtype=torch.int32, device="cuda")
        lse = torch.zeros((2, 4, 64), dtype=torch.float32, device="cuda")
        msgs = []
        try:
            flash_attention_bwd(q, k, v, q, lse, q, pos, pos)
        except NotImplementedError as e:
            msgs.append(str(e))
        before = {n: fn.launches for n, fn in _counters().items()}
        lse_before = flash_attention.lse_launches
        try:
            with torch.enable_grad():
                flash_attention(q.requires_grad_(True), k, v, pos, pos)
        except NotImplementedError as e:
            msgs.append(str(e))
        torch.cuda.synchronize()
        after = {n: fn.launches for n, fn in _counters().items()}
        check(len(msgs) == 2 and all("Queue 2 item A" in m for m in msgs)
              and after == before and flash_attention.lse_launches == lse_before,
              f"flash_attention D = {D}: the backward entry and the autograd path raise "
              f"naming Queue 2 item A, and no kernel launched ({msgs[-1] if msgs else None})")


def check_rmsnorm(torch) -> dict:
    """The RMSNorm forward at the widths the serving paths give it (960
    smollm-360m, 2048 mamba2-1.3b and deepseek-v2-lite-16b, 2560
    h2o-danube-1.8b, 512 deepseek's MLA ``kv_norm``; Triton specializes its
    block and warps per width), each at the prefill's, a ragged and the
    decode step's row count. Timed at smollm's prefill shape (the row), at
    danube's (under ``d2560``) and at deepseek's kv_norm (under ``d512``)."""
    from repro_torch.kernels.rmsnorm import rmsnorm_ref
    from repro_torch.kernels.rmsnorm.ops import rmsnorm

    g = torch.Generator(device="cuda").manual_seed(1)
    # fp32: max-abs <= 1e-5 (summation order). bf16: both sides round the
    # same fp32 value, so per element |d| <= 2**-6 |ref| (see BF16_RTOL),
    # plus 1e-6 for the fp32 noise of elements near 0, and max-abs <= 2e-2
    row = None
    for d in (960, 2048, 2560, 512):
        scale = 0.5 + 0.05 * torch.randn(d, generator=g, device="cuda")
        for rows, dtype in [(BATCH * PROMPT, torch.bfloat16), (BATCH * PROMPT, torch.float32),
                            (37, torch.bfloat16), (37, torch.float32),
                            (BATCH, torch.bfloat16), (BATCH, torch.float32)]:
            x = torch.randn((rows, d), generator=g, device="cuda").to(dtype)
            out = rmsnorm(x, scale)
            ref = rmsnorm_ref(x, scale)
            if dtype == torch.float32:
                err, worst = excess(out, ref, 1e-5)
            else:
                err, worst = excess(out, ref, BF16_RTOL * ref.float().abs() + 1e-6)
                worst = max(worst, err / BF16_MAX_ABS)
            check(out.dtype == dtype and out.shape == x.shape and worst <= 1.0,
                  f"rmsnorm ({rows}, {d}) {dtype}: max_abs_err {err:.3e}, worst "
                  f"|d|/limit {worst:.3f} <= 1")
            if (rows, dtype) != (BATCH * PROMPT, torch.bfloat16) or d == 2048:
                continue
            # library_ms: F.rms_norm takes bf16 rows with an fp32 scale and
            # returns bf16 (PyTorch warns that it cannot use its fused kernel
            # for the mixed dtypes); held to the kernel's limits before it is
            # timed
            library = lambda: torch.nn.functional.rms_norm(x, (d,), scale, 1e-5)  # noqa: E731
            lib_out = library()
            lerr, lworst = excess(lib_out, ref, BF16_RTOL * ref.float().abs() + 1e-6)
            check(lib_out.dtype == dtype and lib_out.shape == x.shape
                  and max(lworst, lerr / BF16_MAX_ABS) <= 1.0,
                  f"F.rms_norm ({rows}, {d}) {dtype}, fp32 scale: max_abs_err {lerr:.3e}, "
                  f"worst |d|/limit {lworst:.3f} <= 1 (the kernel's limits)")
            ms = time_ms(lambda: rmsnorm(x, scale), iters=50)
            plain_ms = time_ms(lambda: rmsnorm_ref(x, scale), iters=50)
            lib_ms = time_ms(library, iters=50)
            nbytes = 2 * x.numel() * x.element_size() + scale.numel() * 4
            ops = 4 * x.numel() + rows          # square, add, 2 multiplies; rsqrt
            bound = max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS["float32"]) * 1e3
            by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / PEAK_OPS["float32"] else "operations"
            name = "main" if d == 960 else f"d{d}"
            print(f"rmsnorm {name} ({rows}, {d}) bf16: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, F.rms_norm {lib_ms:.4f} ms, bound {bound:.4f} ms ({by}; "
                  f"{nbytes} bytes)", flush=True)
            timed = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}
            if d == 960:
                row = {"name": "rmsnorm", "route": "triton",
                       "source": "src/repro_torch/kernels/rmsnorm/kernel.py",
                       "replaces": "src/repro/kernels/rmsnorm/kernel.py:29", **timed}
            else:                       # danube's prefill shape, deepseek's kv_norm
                row[name] = {"shape": f"({rows}, {d}) bf16", **timed}
    return row


def _ssd_inputs(torch, g, B, L, H, P, G, N, dtype, *, dt_scale=1.0, zero_dt=0.0,
                a_max=16.0):
    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    x = rnd(B, L, H, P).to(dtype)
    dt = torch.nn.functional.softplus(rnd(B, L, H)) * dt_scale
    if zero_dt:
        dt = dt * (torch.rand((B, L, H), generator=g, device="cuda") >= zero_dt)
    # A in -[1, a_max)
    A = -torch.exp(torch.rand((H,), generator=g, device="cuda") * math.log(a_max))
    return x, dt, A, (0.5 * rnd(B, L, G, N)).to(dtype), (0.5 * rnd(B, L, G, N)).to(dtype)


def ssd_work(torch, L: int, cl: int, B: int, H: int, P: int, G: int, N: int) -> float:
    """Operations the SSD function needs: per chunk of r rows, r(r+1)/2
    visible (i, j) pairs, each 2N for C.B^T (once per group) and 2P for W x
    (per head); per row and head, 2PN for the inter-chunk C.S and 2PN for
    the state update."""
    pairs = sum(r * (r + 1) // 2 for r in
                [min(cl, L - c0) for c0 in range(0, L, cl)])
    return B * pairs * (2 * N * G + 2 * P * H) + B * L * H * 4 * P * N


def check_ssd(torch) -> dict:
    from repro_torch.kernels.ssd import ssd_ref
    from repro_torch.kernels.ssd.ops import ssd
    from repro_torch.utils import round_up

    g = torch.Generator(device="cuda").manual_seed(2)
    # Per element, y and the final state: |d| <= rtol |ref| + 1e-5 ref_abs,
    # where ref_abs is the plain version run on |x|, |B|, |C|: the sum of the
    # magnitudes of the terms, which bounds what fp32 summation in another
    # order can change (1e-5 is ~170 fp32 ulps of it). rtol is 2**-6 for bf16
    # y (both sides round one fp32 value to bf16; see BF16_RTOL) and 2**-20
    # for fp32. Both sides get the same within-chunk cumsum (fp64, rounded
    # once), so exp(cum_i - cum_j) adds no error of its own.
    # With dt ~ softplus(randn) and A in -[1, 16), a row decays by e^-0.8 or
    # more, so only the last ~30 rows before i weigh in: far j-tiles, the
    # inter-chunk term past a chunk's first rows and the early rows' share of
    # the state are below what the limits see. The small_dt cases take dt
    # about 0.01 (trained Mamba2 keeps dt in [1e-3, 1e-1]) and A in -[1, 2):
    # exp(cum_i - cum_j) stays above ~e^-4 across a 256-row chunk, and the
    # state carries every row through all four chunks.
    cases = [
        # name, B, L, H, P, G, N, chunk, dtype, dt_scale, zero_dt share, a_max
        ("main", BATCH, PROMPT, 64, 64, 1, 128, 256, torch.bfloat16, 1.0, 0.0, 16.0),
        ("main_small_dt", BATCH, PROMPT, 64, 64, 1, 128, 256, torch.bfloat16,
         0.01, 0.0, 2.0),
        ("ragged1000", 2, 1000, 64, 64, 1, 128, 256, torch.bfloat16, 1.0, 0.0, 16.0),
        ("short100", 2, 100, 64, 64, 1, 128, 256, torch.bfloat16, 1.0, 0.0, 16.0),
        ("groups8", 2, 512, 64, 64, 8, 128, 256, torch.bfloat16, 1.0, 0.0, 16.0),
        ("fp32", 2, 600, 64, 64, 1, 128, 256, torch.float32, 1.0, 0.0, 16.0),
        ("fp32_small_dt", 2, 1000, 64, 64, 1, 128, 256, torch.float32, 0.01, 0.0, 2.0),
        ("smoke", 2, 70, 12, 16, 1, 16, 32, torch.float32, 1.0, 0.0, 16.0),
        ("smoke_bf16", 2, 70, 12, 16, 1, 16, 32, torch.bfloat16, 1.0, 0.0, 16.0),
        ("large_dt", 2, 300, 16, 64, 1, 128, 256, torch.bfloat16, 20.0, 0.2, 16.0),
        ("chunk64_L300", 2, 300, 64, 64, 1, 128, 64, torch.bfloat16, 1.0, 0.0, 16.0),
        ("L5", 2, 5, 64, 64, 1, 128, 256, torch.bfloat16, 1.0, 0.0, 16.0),
    ]
    row = None
    for name, B, L, H, P, G, N, chunk, dtype, dt_scale, zero_dt, a_max in cases:
        x, dt, A, Bm, Cm = _ssd_inputs(torch, g, B, L, H, P, G, N, dtype,
                                       dt_scale=dt_scale, zero_dt=zero_dt, a_max=a_max)
        y, st = ssd(x, dt, A, Bm, Cm, chunk=chunk)
        torch.cuda.synchronize()
        cl = min(chunk, round_up(L, 8))
        yr, sr = ssd_ref(x, dt, A, Bm, Cm, chunk=cl)
        ya, sa = ssd_ref(x.abs(), dt, A, Bm.abs(), Cm.abs(), chunk=cl)
        rtol = BF16_RTOL if dtype == torch.bfloat16 else 2.0 ** -20
        err, worst = excess(y, yr, rtol * yr.float().abs() + 1e-5 * ya.float())
        serr, sworst = excess(st, sr, rtol * sr.abs() + 1e-5 * sa)
        check(y.dtype == dtype and y.shape == x.shape and st.shape == (B, H, P, N)
              and bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
              and max(worst, sworst) <= 1.0,
              f"ssd {name}: y max_abs_err {err:.3e}, worst |d|/limit {worst:.3f}; "
              f"state {serr:.3e}, {sworst:.3f} <= 1 (|d| <= {rtol:.3g} |ref| "
              f"+ 1e-5 ref_abs)")
        if name != "main":
            continue
        ms = time_ms(lambda: ssd(x, dt, A, Bm, Cm, chunk=chunk), iters=10)
        plain_ms = time_ms(lambda: ssd_ref(x, dt, A, Bm, Cm, chunk=cl), iters=3, rounds=3)
        # the useful operations (ssd_work, not the split's extra passes)
        # over the tensor cores' bf16 rate, which is where the products run,
        # and, beside it, over the fp32 CUDA-core rate
        ops = ssd_work(torch, L, cl, B, H, P, G, N)
        nbytes = sum(t.numel() * t.element_size() for t in (x, dt, A, Bm, Cm, y, st))
        t_bytes = nbytes / HBM_BYTES_PER_S
        bound = max(t_bytes, ops / PEAK_OPS["bfloat16"]) * 1e3
        by = "operations" if ops / PEAK_OPS["bfloat16"] > t_bytes else "bytes"
        bound_fp32 = max(t_bytes, ops / PEAK_OPS["float32"]) * 1e3
        print(f"ssd main (B={B} L={L} H={H} P={P} G={G} N={N} chunk {cl} "
              f"{str(dtype)[6:]}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound:.4f} ms on the tensor cores ({by}; {ops:.4e} ops at "
              f"989 TFLOP/s, {nbytes} bytes), {bound_fp32:.4f} ms on the fp32 "
              f"CUDA cores", flush=True)
        # library_ms: none. No single PyTorch call computes the SSD scan.
        row = {"name": "ssd", "route": "cuda",
               "source": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
               "replaces": "src/repro/kernels/ssd/kernel.py:83",
               "max_abs_err": max(err, serr), "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": by, "library_ms": None}
    return row


# ---------------------------------------------------------------------------
# backward kernels against their plain versions
# ---------------------------------------------------------------------------

def _bwd_magnitudes(torch, q, k, v, out, lse, dout, qp, kp, *, causal, window, softcap):
    """Per element of dq, dk, dv, the sum of the magnitudes of its terms in
    fp32: scale sum_j m_ij |k_j|, scale sum_i m_ij |q_i|, sum_i P_ij |dO_i|,
    from the plain version's P and dS, with m = |dS| + 2**-8 P (|dP| +
    |delta|). Rounding one factor of every term to bf16 (relative error <=
    2**-9) moves a gradient by at most 2**-9 of the sum over |dS|. The second
    part of m is for dS = P (dP - delta) itself, whose two terms both sides
    sum in fp32 in another order before they cancel: where dP = delta
    exactly (row 0 of a causal mask sees only itself) the plain version
    keeps ~1e-8 of noise, the kernel another."""
    from repro_torch.kernels.flash_attention.ref import _scores
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    s, t, ok = _scores(q, k, qp, kp, causal, window, softcap)
    p = torch.where(ok, torch.exp(s - lse.float().reshape(B, KV, G, Sq)[..., None]), 0.0)
    do = dout.float().reshape(B, Sq, KV, G, D)
    delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1).reshape(B, KV, G, Sq)
    dp = torch.einsum("bqkgd,bskd->bkgqs", do, v.float())
    ds = p * (dp - delta[..., None])
    noise = p * (dp.abs() + delta.abs()[..., None])
    if t is not None:
        ds, noise = ds * (1.0 - t * t), noise * (1.0 - t * t)
    ds = ds.abs() + 2.0 ** -8 * noise
    del s, t, ok, dp, noise
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float().abs()) * D ** -0.5
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds,
                      q.float().abs().reshape(B, Sq, KV, G, D)) * D ** -0.5
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, do.abs())
    return dq.reshape(B, Sq, H, D), dk, dv


def check_flash_bwd(torch) -> dict:
    """The backward kernel's dq, dk, dv and the training forward's LSE
    against the plain versions, on the main path's shape and on every mask
    and shape the forward takes."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_ref, flash_attention_ref
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_attention_bwd,
                                                         flash_attention_with_lse)
    from repro_torch.models.attention import _mask

    g = torch.Generator(device="cuda").manual_seed(3)
    # Both sides get the same q, k, v, dO and the plain forward's out and lse,
    # so the check sees the backward alone. fp32 (CUDA cores on both sides):
    # |d| <= 1e-4 max|ref| per gradient (summation order, ~1e-6). bf16, per
    # element: |d| <= 2**-7 |ref| + 2**-8 A, A being the sum of the
    # magnitudes of the element's terms (_bwd_magnitudes): the kernel rounds
    # P and dS to bf16 for the dV, dK, dQ products (as FlashAttention-2 does),
    # at most 2**-9 of each term, and both sides round the result to bf16
    # once, so they may land one ulp (2**-8 |ref|) apart. The LSE, fp32 on
    # both sides: |d| <= 1e-4 (ex2.approx and summation order, ~1e-6 of a
    # value of ~10), +inf in the same rows.
    cases = [
        # name, B, Sq, Skv, H, KV, D, dtype, causal, window, softcap
        ("main", TRAIN_MB, TRAIN_SEQ, TRAIN_SEQ, 15, 5, 64, torch.bfloat16, True, 0, 0.0),
        ("fp32", 2, 257, 257, 15, 5, 64, torch.float32, True, 0, 0.0),
        ("fp32_masked", 1, 70, 150, 4, 2, 128, torch.float32, True, 0, 0.0),
        ("window24", 2, 300, 300, 15, 5, 64, torch.bfloat16, True, 24, 0.0),
        ("softcap30", 2, 200, 200, 15, 5, 64, torch.bfloat16, True, 0, 30.0),
        ("noncausal", 2, 96, 160, 6, 3, 64, torch.bfloat16, False, 0, 0.0),
        ("bf16_masked", 2, 70, 150, 4, 2, 64, torch.bfloat16, True, 0, 0.0),
        ("per_batch_pos", 3, 150, 300, 15, 5, 64, torch.bfloat16, True, 0, 0.0),
        ("g1", 2, 200, 200, 4, 4, 64, torch.bfloat16, True, 0, 0.0),
        ("d128", 2, 300, 300, 8, 2, 128, torch.bfloat16, True, 0, 0.0),
        ("d128_window24", 2, 300, 300, 8, 2, 128, torch.bfloat16, True, 24, 0.0),
        # past the 32 tiles a producer scans in one pass (dK/dV: 2048 q rows
        # at D = 64, 1024 at D = 128; dQ: 2048 kv slots)
        ("long_scan", 1, 2200, 2200, 2, 1, 64, torch.bfloat16, True, 0, 0.0),
        ("d128_long_scan", 1, 1100, 1100, 2, 1, 128, torch.bfloat16, True, 0, 0.0),
    ]
    row = None
    for name, B, Sq, Skv, H, KV, D, dtype, causal, window, softcap in cases:
        q, k, v = _attn_inputs(torch, g, B, Sq, Skv, H, KV, D, dtype)
        dout = torch.randn((B, Sq, H, D), generator=g, device="cuda").to(dtype)
        off = max(Skv - Sq, 0)
        qp = torch.arange(off, off + Sq, dtype=torch.int32, device="cuda")
        kp = torch.arange(Skv, dtype=torch.int32, device="cuda")
        if name.endswith("_masked"):    # empty slots and fully masked rows
            kp = kp + 10
            kp[-40:] = -1
            qp = torch.arange(Sq, dtype=torch.int32, device="cuda") - 5
        qp, kp = qp.expand(B, Sq), kp.expand(B, Skv)
        if name == "per_batch_pos":
            kp = kp + torch.tensor([0, 37, 0], dtype=torch.int32, device="cuda")[:, None]
            qp = qp - torch.tensor([0, 0, 50], dtype=torch.int32, device="cuda")[:, None]
        kw = dict(causal=causal, window=window, softcap=softcap)
        out_k, lse_k = flash_attention_with_lse(q, k, v, qp, kp, **kw)
        out, lse = flash_attention_ref(q, k, v, qp, kp, return_lse=True, **kw)
        grads = flash_attention_bwd(q, k, v, out, lse, dout, qp, kp, **kw)
        again = flash_attention_bwd(q, k, v, out, lse, dout, qp, kp, **kw)
        torch.cuda.synchronize()
        refs = flash_attention_bwd_ref(q, k, v, out, lse, dout, qp, kp, **kw)
        dropped = flash_attention_bwd_ref(q, k, v, out, lse, dout, qp, kp,
                                          delta=torch.zeros_like(lse), **kw)
        if dtype == torch.float32:
            limits = [1e-4 * r.float().abs().max() for r in refs]
            what = "|d| <= 1e-4 max|ref|"
        else:
            mags = _bwd_magnitudes(torch, q, k, v, out, lse, dout, qp, kp, **kw)
            limits = [2.0 ** -7 * r.float().abs() + 2.0 ** -8 * a for r, a in zip(refs, mags)]
            what = "|d| <= 2**-7 |ref| + 2**-8 A"
        res = [excess(x, r, lim) for x, r, lim in zip(grads, refs, limits)]
        err, worst = max(e for e, _ in res), max(w for _, w in res)
        per = ", ".join(f"d{n} {w:.3f}" for n, (_, w) in zip("qkv", res))
        # negative control: the plain gradient without its delta term
        bad = max(excess(x, r, lim)[1] for x, r, lim in zip(dropped[:2], refs[:2], limits[:2]))
        inf_k, inf_r = torch.isinf(lse_k), torch.isinf(lse)
        fin = ~inf_r
        lse_err = (lse_k[fin] - lse[fin]).abs().max().item()
        check(all(x.dtype == dtype and x.shape == r.shape and bool(torch.isfinite(x).all())
                  for x, r in zip(grads, refs)) and worst <= 1.0,
              f"flash_attention_bwd {name}: max_abs_err {err:.3e}, worst |d|/limit "
              f"{worst:.3f} <= 1 ({per}; {what})")
        check(all(torch.equal(a, b) for a, b in zip(grads, again)),
              f"flash_attention_bwd {name}: two calls give the same bits")
        check(bad > 1.0, f"flash_attention_bwd {name}: the plain gradient without delta "
                         f"fails the limit (worst |d|/limit {bad:.1f} > 1)")
        check(torch.equal(inf_k, inf_r) and lse_err <= 1e-4
              and bool((lse_k[inf_k] > 0).all()) and torch.equal(out_k, flash_attention(
                  q, k, v, qp, kp, **kw)),
              f"flash_attention LSE forward {name}: lse max_abs_err {lse_err:.3e} <= 1e-4, "
              f"+inf in the same {int(inf_r.sum())} rows, output equal to the serving "
              f"kernel's")
        if name.endswith("_masked"):
            dead = grads[0][:, :10].abs().max().item()   # q_pos < 10: nothing visible
            check(dead == 0.0, f"flash_attention_bwd fully masked rows: dq 0 ({dead})")
        if name != "main":
            continue
        # ~1.1 ms of sleep per call: SDPA's backward goes through the
        # autograd engine, whose host time per call exceeded the default on
        # a slow host (0.3132 to 0.4846 ms read across calls); both sides
        # get the same
        ms = time_ms(lambda: flash_attention_bwd(q, k, v, out, lse, dout, qp, kp, **kw),
                     iters=10, sleep_per_iter=2_000_000)
        plain_ms = time_ms(lambda: flash_attention_bwd_ref(q, k, v, out, lse, dout, qp, kp,
                                                           **kw), iters=3, rounds=3)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        o_sdpa = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
        do_t = dout.transpose(1, 2)
        lib_ms = time_ms(lambda: torch.autograd.grad(o_sdpa, (qt, kt, vt), do_t,
                                                     retain_graph=True), iters=10,
                         sleep_per_iter=2_000_000)
        # the work these inputs need: five products of length D (S, dP, dV,
        # dK, dQ) per visible (q, kv) pair and head, 10 D operations; each
        # input (q, k, v, out, dout, lse, positions) read once, each output
        # (dq, dk, dv) written once
        pairs = _mask(qp[:, :, None], kp[:, None, :], window, causal).sum().item()
        ops = 10 * D * H * pairs
        nbytes = sum(t.numel() * t.element_size()
                     for t in (q, k, v, out, dout, lse, qp, kp, *grads))
        bound = max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS["bfloat16"]) * 1e3
        by = "operations" if ops / PEAK_OPS["bfloat16"] > nbytes / HBM_BYTES_PER_S else "bytes"
        fwd_ms = time_ms(lambda: flash_attention(q, k, v, qp, kp, **kw))
        fwd_lse_ms = time_ms(lambda: flash_attention_with_lse(q, k, v, qp, kp, **kw))
        print(f"flash_attention_bwd main (B={B} S={Sq} H={H} KV={KV} D={D} bf16 causal): "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa backward {lib_ms:.4f} ms, "
              f"bound {bound:.4f} ms ({by}; {ops:.4e} ops, {nbytes} bytes); forward at "
              f"this shape: serving entry {fwd_ms:.4f} ms, LSE entry {fwd_lse_ms:.4f} ms",
              flush=True)
        row = {"name": "flash_attention_bwd", "route": "cuda",
               "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu",
               # no Pallas kernel has a backward: this is the gradient the
               # JAX package takes by autodiff of its jnp oracle
               "replaces": "src/repro/models/attention.py:101",
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}
    return row


def check_rmsnorm_bwd(torch) -> dict:
    """The RMSNorm backward kernel's dx and dscale against the plain
    version, at the train path's shape and at ragged row counts."""
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_ref
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_bwd

    g = torch.Generator(device="cuda").manual_seed(4)
    # dx: fp32 |d| <= 1e-5 (summation order); bf16 per element |d| <= 2**-6
    # |ref| + 1e-6 (both sides round one fp32 value: see BF16_RTOL). dscale,
    # fp32 on both sides, a sum over all rows: |d| <= 1e-5 A, A being the sum
    # of the magnitudes of its terms, sum |dy x_hat| (fp32 summation order).
    # Negative control: the plain dx without its mean(dy s x_hat) term.
    d = 960
    scale = 0.5 + 0.05 * torch.randn(d, generator=g, device="cuda")
    rows_main = TRAIN_MB * TRAIN_SEQ
    row = None
    for rows, dtype in [(rows_main, torch.bfloat16), (rows_main, torch.float32),
                        (37, torch.bfloat16), (37, torch.float32), (1, torch.float32),
                        (1000, torch.bfloat16)]:
        x = torch.randn((rows, d), generator=g, device="cuda").to(dtype)
        dy = torch.randn((rows, d), generator=g, device="cuda").to(dtype)
        dx, ds = rmsnorm_bwd(x, scale, dy)
        dx2, ds2 = rmsnorm_bwd(x, scale, dy)
        torch.cuda.synchronize()
        rdx, rds = rmsnorm_bwd_ref(x, scale, dy)
        x32 = x.float()
        xhat = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-5)
        a = (dy.float() * xhat).abs().sum(0)
        broken = (torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-5)
                  * dy.float() * scale).to(dtype)
        lim = 1e-5 if dtype == torch.float32 else BF16_RTOL * rdx.float().abs() + 1e-6
        err, worst = excess(dx, rdx, lim)
        serr, sworst = excess(ds, rds, 1e-5 * a)
        bad = excess(broken, rdx, lim)[1]
        check(dx.dtype == dtype and ds.dtype == torch.float32 and dx.shape == x.shape
              and max(worst, sworst) <= 1.0,
              f"rmsnorm_bwd ({rows}, {d}) {dtype}: dx max_abs_err {err:.3e}, worst "
              f"|d|/limit {worst:.3f}; dscale {serr:.3e}, {sworst:.3f} <= 1")
        check(torch.equal(dx, dx2) and torch.equal(ds, ds2),
              f"rmsnorm_bwd ({rows}, {d}) {dtype}: two calls give the same bits")
        check(bad > 1.0, f"rmsnorm_bwd ({rows}, {d}) {dtype}: the plain dx without its "
                         f"mean term fails the limit ({bad:.1f} > 1)")
        if (rows, dtype) != (rows_main, torch.bfloat16):
            continue
        # library_ms: the autograd backward of F.rms_norm (bf16 rows, fp32
        # scale, as check_rmsnorm), held to the kernel's limits first; ~1.1
        # ms of sleep per call, as the flash backward's, for the autograd
        # engine's host time
        xr, sr = x.detach().requires_grad_(True), scale.detach().requires_grad_(True)
        y = torch.nn.functional.rms_norm(xr, (d,), sr, 1e-5)
        library = lambda: torch.autograd.grad(y, (xr, sr), dy,   # noqa: E731
                                              retain_graph=True)
        ldx, lds = library()
        lerr, lworst = excess(ldx, rdx, lim)
        lserr, lsworst = excess(lds, rds, 1e-5 * a)
        check(ldx.dtype == dtype and lds.dtype == torch.float32 and max(lworst, lsworst) <= 1.0,
              f"F.rms_norm backward ({rows}, {d}) {dtype}: dx max_abs_err {lerr:.3e}, worst "
              f"|d|/limit {lworst:.3f}; dscale {lserr:.3e}, {lsworst:.3f} <= 1 (the kernel's "
              f"limits)")
        ms = time_ms(lambda: rmsnorm_bwd(x, scale, dy), iters=50)
        plain_ms = time_ms(lambda: rmsnorm_bwd_ref(x, scale, dy), iters=20)
        lib_ms = time_ms(library, iters=50, sleep_per_iter=2_000_000)
        nbytes = 3 * x.numel() * x.element_size() + 2 * d * 4   # x, dy, dx; scale, dscale
        ops = 10 * x.numel() + rows
        bound = max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS["float32"]) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / PEAK_OPS["float32"] else "operations"
        print(f"rmsnorm_bwd main ({rows}, {d}) bf16: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, F.rms_norm backward {lib_ms:.4f} ms, bound {bound:.4f} ms "
              f"({by}; {nbytes} bytes)", flush=True)
        row = {"name": "rmsnorm_bwd", "route": "triton",
               "source": "src/repro_torch/kernels/rmsnorm/kernel.py",
               # autodiff of the JAX package's layers.rmsnorm (no Pallas VJP)
               "replaces": "src/repro/models/layers.py:28",
               "max_abs_err": max(err, serr), "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}
    return row


# ---------------------------------------------------------------------------
# the slice end to end
# ---------------------------------------------------------------------------

ARCHS = ("smollm-360m", "mamba2-1.3b", "h2o-danube-1.8b")
# The checks that cross a sliding window, run for every served arch that has
# one: a cache parity run of one prompt of CROSS_PROMPT_PER_WINDOW windows
# (at danube's 4096, 6144 tokens: prefill masks up to 2048 positions of a
# late query and the ring has wrapped) and GEN decode steps; and the
# card-vs-CPU check (2 layers, a 600-token prompt) with the window cut to
# CARD_VS_CPU_WINDOW
CROSS_PROMPT_PER_WINDOW, CARD_VS_CPU_WINDOW = 1.5, 256
TRAIN_PATH = "train smollm-360m"
# deepseek-v2-lite-16b served at full width, cut to its dense first layer and
# 7 MoE layers (94.2 GB at full depth does not fit the card), registered under
# this name; its fp32 parity model has the same depth
DEEPSEEK, DEEPSEEK_LAYERS = "deepseek-v2-lite-16b", 8
DEEPSEEK_PATH = f"{DEEPSEEK}-{DEEPSEEK_LAYERS}l"
SERVED = (*ARCHS, DEEPSEEK_PATH)
# MoE routing is discontinuous: where the 6th and 7th of 64 router
# probabilities nearly tie, summation order alone may swap the two experts.
# A token whose top-k set differs between two runs, at the first layer where
# it differs, must be such a near-tie on the reference side: its k-th minus
# (k+1)-th probability <= NEAR_TIE. From there on the token's hidden state
# differs by a whole expert's share, so its later layers may route apart
# without a near-tie.
NEAR_TIE = 1e-4


def register_deepseek_cut() -> None:
    """Registers DEEPSEEK_PATH: deepseek-v2-lite-16b at every published width,
    cut to DEEPSEEK_LAYERS layers, served through ServeSession as any arch."""
    from repro_torch.config import get_arch, register_arch
    full = get_arch(DEEPSEEK)
    register_arch(DEEPSEEK_PATH)(lambda: dataclasses.replace(
        full, name=DEEPSEEK_PATH, num_layers=DEEPSEEK_LAYERS))
    cut, ref = dataclasses.asdict(get_arch(DEEPSEEK_PATH)), dataclasses.asdict(full)
    differ = sorted(k for k in ref if cut[k] != ref[k])
    check(differ == ["name", "num_layers"] and cut["num_layers"] == DEEPSEEK_LAYERS,
          f"{DEEPSEEK_PATH}: equal to {DEEPSEEK} field for field but {differ} "
          f"(num_layers {ref['num_layers']} -> {cut['num_layers']})")


@contextlib.contextmanager
def record_routes():
    """Records (top-k indices, router probabilities) of every MoE router
    call, in call order, on the host."""
    from repro_torch.models import moe
    calls, route = [], moe._route

    def recorded(router_w, x, cfg):
        gates, idx, probs = route(router_w, x, cfg)
        calls.append((idx.cpu(), probs.cpu()))
        return gates, idx, probs
    moe._route = recorded
    try:
        yield calls
    finally:
        moe._route = route


def _routes_by_layer(calls, n_layers: int, B: int) -> list:
    """Per MoE layer, (indices (B, S, k), probabilities (B, S, E)) from the
    router calls of one forward, or of a prefill and its decode steps."""
    import torch
    out = []
    for layer in range(n_layers):
        mine = calls[layer::n_layers]
        idx = torch.cat([i.reshape(B, -1, i.shape[-1]) for i, _ in mine], dim=1)
        probs = torch.cat([p.reshape(B, -1, p.shape[-1]) for _, p in mine], dim=1)
        out.append((idx, probs))
    return out


def route_flips(label: str, ref_calls, calls, n_layers: int, B: int, k: int):
    """Compares two runs' top-k expert sets token by token, per MoE layer in
    order (ref: the reference side). A token's first flip must be a near-tie
    on the reference side (NEAR_TIE); a flip of a token that an earlier
    layer flipped already is its consequence. Prints the flips per layer,
    first flips apart; returns (B, S) True where a token flipped in any
    layer."""
    import torch
    flipped, per_layer, first, worst = None, [], [], 0.0
    for (ri, rp), (ti, _) in zip(_routes_by_layer(ref_calls, n_layers, B),
                                 _routes_by_layer(calls, n_layers, B)):
        f = (ri.sort(-1).values != ti.sort(-1).values).any(-1)
        new = f if flipped is None else f & ~flipped
        top = rp.topk(k + 1, dim=-1).values
        gap = top[..., k - 1] - top[..., k]
        if bool(new.any()):
            worst = max(worst, gap[new].max().item())
            where = new.nonzero().tolist()[:8]
            print(f"{label}: MoE layer {len(per_layer)}: first flips at (row, position) "
                  f"{where}, top-{k} gaps {[f'{gap[b, t].item():.2e}' for b, t in where]}",
                  flush=True)
        per_layer.append(int(f.sum()))
        first.append(int(new.sum()))
        flipped = f if flipped is None else flipped | f
    check(worst <= NEAR_TIE,
          f"{label}: {int(flipped.sum())} of {flipped.numel()} tokens routed apart in "
          f"{n_layers} MoE layers (flips per layer {per_layer}, first flips {first}); "
          f"each first flip a near-tie: top-{k} gap <= {worst:.3e} <= {NEAR_TIE} on the "
          f"reference side")
    return flipped


def _counters() -> dict:
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_bwd
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_bwd
    from repro_torch.kernels.ssd.ops import ssd
    return {"flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
            "rmsnorm": rmsnorm, "rmsnorm_bwd": rmsnorm_bwd, "ssd": ssd}


def reset_counters() -> None:
    from repro_torch.kernels.flash_attention.ops import flash_attention
    for fn in _counters().values():
        fn.launches = 0
    flash_attention.lse_launches = 0


def expected_launches(cfg) -> tuple[dict, dict]:
    """Kernel launches per forward (prefill) and per decode step: flash and
    SSD once per attention / mamba layer in a forward and never in decode;
    RMSNorm for ln1, for ln2 where there is an MLP (dense or MoE), for
    mamba's gated norm, and once for the final norm, in both. MLA's latent
    (``_mla_latent``: ``kv_norm``, and ``q_norm`` with a q LoRA) runs twice
    per layer in a prefill (the attention and the cache, as the reference
    does) and once per decode step; a training forward (no cache) runs it
    once. Serving launches no backward."""
    from repro_torch.models.model import layer_plans
    plans = layer_plans(cfg)
    attn = sum(p.mixer == "attn" for p in plans)
    mla = attn * (1 + bool(cfg.attention.q_lora_rank)) \
        if cfg.attention is not None and cfg.attention.kind == "mla" else 0
    norms = 1 + sum(1 + (p.mlp != "none") + (p.mixer == "mamba") for p in plans)
    prefill = {"flash_attention": attn, "ssd": sum(p.mixer == "mamba" for p in plans),
               "rmsnorm": norms + 2 * mla, "flash_attention_bwd": 0, "rmsnorm_bwd": 0}
    return prefill, dict(prefill, flash_attention=0, ssd=0, rmsnorm=norms + mla)


def cache_sizes(sess) -> str:
    caches = sess._caches
    sizes: dict[str, int] = {}
    for seg in caches:
        for layer in seg:
            for kind, leaves in layer.items():
                for name, t in leaves.items():
                    key = f"{kind}/{name}"
                    sizes[key] = sizes.get(key, 0) + t.numel() * t.element_size()
    return ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in sizes.items())


def serve_path(torch, arch: str) -> tuple[dict, object, dict, torch.Tensor]:
    from repro_torch.launch.serve import ServeSession

    from repro_torch.kernels.flash_attention.ops import flash_attention
    counters = _counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sess = ServeSession(arch)
    cfg = sess.cfg
    n_params = sum(t.numel() for t in sess.model.parameters())
    print(f"ServeSession {arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{n_params} parameters, {cfg.dtype}, built in {time.perf_counter() - t0:.1f} s "
          f"(the seeded init drawn on the host)", flush=True)
    batch = sess.make_batch(BATCH, PROMPT, seed=0)

    reset_counters()
    sess.prefill(batch)
    torch.cuda.synchronize()
    after_prefill = {n: fn.launches for n, fn in counters.items()}
    gen, _ = sess.decode_step(GEN)
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in counters.items()}
    per_fwd, per_step = expected_launches(cfg)
    for name in counters:
        in_decode = launches[name] - after_prefill[name]
        check(after_prefill[name] == per_fwd[name] and in_decode == GEN * per_step[name],
              f"{arch}: {name} launches {after_prefill[name]} in prefill == "
              f"{per_fwd[name]}, {in_decode} in {GEN} decode steps == "
              f"{GEN} x {per_step[name]}")
    check(all(launches[n] > 0 for n in counters if per_fwd[n] or per_step[n]),
          f"{arch}: every kernel of the path launched "
          f"({', '.join(f'{n} {launches[n]}' for n in counters)})")
    check(flash_attention.lse_launches == 0,
          f"{arch}: serving launched the flash forward without LSE only "
          f"({flash_attention.lse_launches} LSE launches)")
    check(gen.shape == (BATCH, GEN) and int(gen.min()) >= 0
          and int(gen.max()) < cfg.padded_vocab,
          f"{arch}: generated tokens {tuple(gen.shape)} in [0, {cfg.padded_vocab})")
    print(f"{arch} caches: {cache_sizes(sess)}", flush=True)

    # again, warm, in two decode calls: the stream must be contiguous
    tp = sess.prefill(batch)
    a, td1 = sess.decode_step(GEN // 2)
    b, td2 = sess.decode_step(GEN - GEN // 2)
    check(torch.equal(torch.cat([a, b], dim=1), gen),
          f"{arch}: two decode_step calls continue one token stream")
    prefill = [tp.tokens_per_s]
    decode = [BATCH * GEN / (td1.seconds + td2.seconds)]
    for _ in range(REPEATS - 1):
        prefill.append(sess.prefill(batch).tokens_per_s)
        decode.append(sess.decode_step(GEN)[1].tokens_per_s)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    e2e = {"prefill_tokens_per_s": sorted(prefill)[len(prefill) // 2],
           "decode_tokens_per_s": sorted(decode)[len(decode) // 2],
           "prefill_samples": prefill, "decode_samples": decode,
           "peak_memory_gb": peak_gb}
    print(f"{arch} end to end (B={BATCH}, prompt {PROMPT}, {GEN} steps; median "
          f"of {REPEATS}): prefill {e2e['prefill_tokens_per_s']:.1f} tokens/s "
          f"[{min(prefill):.1f}, {max(prefill):.1f}], decode "
          f"{e2e['decode_tokens_per_s']:.1f} tokens/s [{min(decode):.1f}, "
          f"{max(decode):.1f}]; peak memory {peak_gb:.2f} GB (build, prefill, decode)",
          flush=True)
    seq = torch.cat([batch["tokens"], gen], dim=1)
    return launches, sess, e2e, seq


def _parity_errors(model, seq, *, prompt: int, zero_cache=False):
    """Per row of ``seq``, max |logits error| of prefill(seq[:, :prompt]) and
    of each decode step against one full forward of ``seq``, as (B, 1 +
    steps); and that forward's logits. With ``zero_cache``, every
    floating-point cache leaf is zeroed after the prefill: a fault the check
    must catch."""
    import torch
    full = model.forward_logits({"tokens": seq}).float()
    logits, caches = model.prefill({"tokens": seq[:, :prompt]},
                                   max_cache_len=seq.shape[1])
    errs = [(logits.float() - full[:, prompt - 1]).abs().amax(-1)]
    if zero_cache:
        with torch.no_grad():
            for seg in caches:
                for layer in seg:
                    for leaves in layer.values():
                        for t in leaves.values():
                            if t.is_floating_point():
                                t.zero_()
    for t in range(prompt, seq.shape[1]):
        logits, caches = model.decode_step(caches, seq[:, t], t)
        errs.append((logits.float() - full[:, t]).abs().amax(-1))
    return torch.stack(errs, dim=1), full


def _fp32_twin(model):
    """The model under its config in fp32, reading the same fp32 masters:
    what ``Model(fp32 config, seed)`` would rebuild (the same seed draws the
    same masters), without drawing or holding them a second time."""
    import torch
    twin = copy.copy(model)
    twin.cfg = dataclasses.replace(model.cfg, dtype="float32")
    twin.dtype = torch.float32
    twin.params_changed()                # its serving copies: the fp32 masters
    return twin


def _check_fp32_parity(torch, label: str, m32, seq, prompt: int):
    """The fp32 rule of check_cache_parity on ``seq``, with its zeroed-cache
    control; returns the full forward's fp32 logits.

    With MoE layers the rule holds the logits of a (row, position) only
    where no layer's top-k expert set at that token differs between the
    full forward and the prefill/decode run (route_flips checks that each
    such flip is a near-tie). A flip changes its own token's hidden state
    from that layer on; it reaches other tokens only through attention, as
    one key among hundreds, which the limit absorbs."""
    with record_routes() as calls:
        errs32, full32 = _parity_errors(m32, seq, prompt=prompt)
    held = torch.ones_like(errs32, dtype=torch.bool)
    n_moe = sum(p.mlp == "moe" for p in m32.plans)
    if n_moe:       # the full forward's router calls, then the prefill's and decode's
        flipped = route_flips(f"{label}: cache parity (fp32)", calls[:n_moe],
                              calls[n_moe:], n_moe, seq.shape[0], m32.cfg.moe.top_k)
        held = ~flipped[:, prompt - 1:].to(errs32.device)
    broken, _ = _parity_errors(m32, seq, prompt=prompt, zero_cache=True)
    scale = full32.abs().max().item()
    limit = 2.0 ** -10 * scale
    err = errs32[held].max().item()
    routed = (f" ({int(held.sum())} of {held.numel()} row logits held, the others at a "
              f"token whose experts flipped; by row "
              f"{[f'{e:.2e}' for e in errs32.where(held, 0).amax(1).tolist()]})") if n_moe else ""
    check(err <= limit and bool(torch.isfinite(full32).all()),
          f"{label}: cache parity (fp32, full width and depth): max_abs logits "
          f"err {err:.3e} <= 2**-10 max|logit| = {limit:.4e} over prefill + "
          f"{errs32.shape[1] - 1} steps{routed}")
    bad = broken[:, 1:][held[:, 1:]].max().item()
    check(bad > limit,
          f"{label}: cache parity fails a zeroed cache: max_abs logits err "
          f"{bad:.3e} > {limit:.4e} over {broken.shape[1] - 1} steps")
    return full32


def check_cache_parity(torch, arch, sess, seq) -> None:
    """Prefill + decode logits against one full forward of the sequence:
    the kernels over all tokens on one side; the kernels over the prompt,
    then the plain decode (attention over the ring cache, or the SSM
    recurrence) on the other. The same rule for every arch, on the prompt
    and GEN seeded random tokens (greedy decoding of random weights repeats
    one token, and rounding drift piles up there).

      * fp32, the session's weights at full width and depth (deepseek's cut
        depth): max |err| <= 2**-10 of the largest |logit|, with MoE routing
        flips handled as _check_fp32_parity says. The two sides differ by fp32
        summation order: on an H100, smollm read 1.6e-5 against 0.0107 and
        mamba 2.4e-3 against 0.0094. The same run with every cache leaf zeroed after the prefill
        must exceed the limit: the check fails a lost state, conv tail or
        KV cache at this depth.
      * bf16, the session itself, is a smoke check and not evidence of a
        right cache: limit max(0.25, 2 e), e being the largest distance
        between the bf16 and the fp32 full forwards over the same positions.
        In mamba's 48 layers bf16 rounding alone moves logits by O(1) (e ~3
        at max |logit| ~10), as large as a cache fault; in deepseek's MoE
        layers bf16 rounding also flips experts, which e includes.

    At 1024 + 32 tokens danube's 4096 window masks nothing, so for an arch
    with a sliding window the fp32 rule runs once more across it: batch 1,
    a prompt of CROSS_PROMPT_PER_WINDOW windows (6144 tokens) and GEN steps, seeded random tokens. Prefill then masks up to
    2048 positions of a late query in the kernel, the 4096-slot ring has
    wrapped before decode, and decode writes over its oldest slots."""
    g = torch.Generator().manual_seed(5)
    tail = torch.randint(0, sess.cfg.vocab_size, (seq.shape[0], seq.shape[1] - PROMPT),
                         generator=g, dtype=seq.dtype)
    seq = torch.cat([seq[:, :PROMPT], tail.to(seq.device)], dim=1)
    errs, full = _parity_errors(sess.model, seq, prompt=PROMPT)
    errs = errs.amax(0).tolist()                  # per step, over the rows
    m32 = _fp32_twin(sess.model)                  # the session's weights
    full32 = _check_fp32_parity(torch, arch, m32, seq, PROMPT)
    scale = full32.abs().max().item()
    noise = (full[:, PROMPT - 1:] - full32[:, PROMPT - 1:]).abs().max().item()
    del full32
    window = sess.cfg.attention.sliding_window if sess.cfg.attention else 0
    if window > 0:
        t0 = time.perf_counter()
        cross_prompt = int(CROSS_PROMPT_PER_WINDOW * window)
        cross = torch.randint(0, sess.cfg.vocab_size, (1, cross_prompt + GEN),
                              generator=torch.Generator().manual_seed(8), dtype=seq.dtype)
        _check_fp32_parity(torch, f"{arch} across the window (B=1, {cross_prompt}-token "
                           f"prompt, window {window})", m32, cross.to(seq.device),
                           cross_prompt)
        print(f"{arch}: the window-crossing parity took {time.perf_counter() - t0:.1f} s, "
              f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    del m32
    print(f"{arch}: cache parity errors by step (bf16): "
          f"{' '.join(f'{e:.3f}' for e in errs)}", flush=True)
    check(max(errs) <= max(0.25, 2 * noise) and bool(torch.isfinite(full).all()),
          f"{arch}: cache parity (bf16 smoke check, not evidence): max_abs "
          f"logits err {max(errs):.4f} <= max(0.25, 2 x {noise:.4f}), {noise:.4f} "
          f"being bf16 against fp32 in the full forward (max |logit| {scale:.2f})")


def check_moe_gather_vs_dense(torch, sess) -> None:
    """``moe_gather_decode`` against ``moe_dense`` at the decode shape (B =
    BATCH, one token), on the session's first MoE layer: in bf16 (its
    serving copies) and fp32 (its masters). Both route the same inputs the
    same way and compute one function. fp32: max |d| <= 1e-5 max |dense|
    (summation order). bf16: max |d| <= 2**-6 max |dense|: the dense path
    rounds each gated hidden unit to bf16 before one product over all
    experts, the gathered path each expert's output before the gated sum,
    each a relative 2**-8 per term. Prints both paths' times (the dense one
    reads every expert's weights, the gathered one top_k per token)."""
    from repro_torch.models import moe
    from repro_torch.models.spec import tree_map
    model, cfg = sess.model, sess.cfg
    si = next(i for i, seg in enumerate(model.segments) if seg.pattern[0].mlp == "moe")
    g = torch.Generator(device="cuda").manual_seed(9)
    x32 = torch.randn((BATCH, 1, cfg.d_model), generator=g, device="cuda")
    for tree, dtype, rtol in ((model._compute, torch.bfloat16, 2.0 ** -6),
                              (model.params_tree(), torch.float32, 1e-5)):
        p = tree_map(lambda _, t: t[0], tree["segments"][si][0]["moe"],
                     is_leaf=lambda t: isinstance(t, torch.Tensor))
        x = x32.to(dtype)
        kw = dict(act=cfg.mlp_act, dtype=dtype)
        dense, aux_d = moe.moe_dense(p, cfg.moe, x, **kw)
        gather, aux_g = moe.moe_gather_decode(p, cfg.moe, x, **kw)
        err = (gather.float() - dense.float()).abs().max().item()
        limit = rtol * dense.float().abs().max().item()
        dense_ms = time_ms(lambda: moe.moe_dense(p, cfg.moe, x, **kw), iters=10)
        gather_ms = time_ms(lambda: moe.moe_gather_decode(p, cfg.moe, x, **kw), iters=10)
        check(err <= limit and torch.equal(aux_d, aux_g),
              f"{cfg.name}: moe_gather_decode vs moe_dense ({dtype}, B={BATCH}, one token, "
              f"{cfg.moe.num_experts} experts, top-{cfg.moe.top_k}): max_abs_err {err:.3e} <= "
              f"{rtol:.3g} max|dense| = {limit:.3e}, aux equal; dense {dense_ms:.4f} ms, "
              f"gather {gather_ms:.4f} ms")


def where_the_time_goes(torch, sess) -> dict:
    """torch.profiler over one warm prefill and 8 decode steps (profile_call)."""
    batch = sess.make_batch(BATCH, PROMPT, seed=0)
    sess.prefill(batch)                            # warm
    return {"prefill": profile_call(torch, lambda: sess.prefill(batch), sess.cfg.name,
                                    "prefill", top_n=6),
            "decode8": profile_call(torch, lambda: sess.decode_step(8), sess.cfg.name,
                                    "decode8", top_n=6)}


def check_card_vs_cpu(torch, arch: str) -> None:
    """Full width, 2 layers, fp32, same weights: card (kernels) vs CPU
    (plain versions). fp32 differs only by summation order (main() turns
    TF32 off for matrix products on the card). The inputs: a forward over
    2 x (prompt + 8) tokens, a prefill of the prompt, 8 decode steps; the
    prompt is 64 tokens for smollm-360m and 600 for mamba2-1.3b (three SSD
    chunks of 256, the last ragged) and h2o-danube-1.8b. For danube the
    window is cut from 4096 to 256 (CARD_VS_CPU_WINDOW): the kernel then
    masks by the window in the forward and the prefill, the 256-slot ring
    has rolled before decode, and the CPU's plain attention stays small. The
    same cut applies to any arch with a sliding window.

    Prefill and decode agree within 1e-3. So does the forward, unless the
    model's own fp32 rounding is larger: where there are SSD layers, the
    CPU runs the same forward with the SSD chunk at half the length, which
    is the same function in exact arithmetic. How far that moves the logits
    (``rechunk``) is how far fp32 rounding alone moves them: in
    exp(cum_i - cum_j) a rounding of the within-chunk cumsum, of size
    ulp(|cum|), becomes a relative error of the decay. The card and the CPU
    are two such roundings, and the card also sums every GEMM in another
    order: the forward limit is max(1e-3, 4 x rechunk). A wrong chunk
    boundary, state or mask moves logits by O(0.1-1)."""
    from repro_torch.config import get_arch
    from repro_torch.models import Model

    prompt, cache_len = (64, 128) if arch in ("smollm-360m", DEEPSEEK) else (600, 0)
    cfg = dataclasses.replace(get_arch(arch), num_layers=2, dtype="float32")
    cut = "2 layers"
    window = cfg.attention.sliding_window if cfg.attention else 0
    if window > 0:
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, sliding_window=CARD_VS_CPU_WINDOW))
        cut += f", sliding_window {window} -> {CARD_VS_CPU_WINDOW}, prompt {prompt}"
    cpu = Model(cfg, device="cpu", seed=1)
    gpu = Model(cfg, device="cuda", seed=2)
    gpu.load_params(cpu.params_tree())
    toks = torch.randint(0, cfg.vocab_size, (2, prompt + 8),
                         generator=torch.Generator().manual_seed(3), dtype=torch.int32)
    n_moe = sum(p.mlp == "moe" for p in cpu.plans)
    with record_routes() as ref_calls:
        ref = cpu.forward_logits({"tokens": toks})
    with record_routes() as calls:
        out = gpu.forward_logits({"tokens": toks.cuda()}).cpu()
    held = torch.ones(toks.shape, dtype=torch.bool)
    if n_moe:
        held = ~route_flips(f"{arch}: card vs CPU forward", ref_calls, calls, n_moe, 2,
                            cfg.moe.top_k)
    err = (out - ref).abs().amax(-1)[held].max().item()
    rechunk = 0.0
    if cfg.ssm is not None:
        half = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, chunk_size=cfg.ssm.chunk_size // 2))
        other = Model(half, device="cpu", seed=2)
        other.load_params(cpu.params_tree())
        rechunk = (other.forward_logits({"tokens": toks}) - ref).abs().max().item()
        del other
    served = {}
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        with record_routes() as served_calls:
            logits, c = model.prefill({"tokens": toks[:, :prompt].to(dev)},
                                      max_cache_len=cache_len)
            out = [logits.cpu()]
            for t in range(prompt, prompt + 8):
                logits, c = model.decode_step(c, toks[:, t].to(dev), t)
                out.append(logits.cpu())
        served[dev] = (torch.stack(out, dim=1), served_calls)
    (lc, ref_calls), (lg, calls) = served["cpu"], served["cuda"]
    held_served = torch.ones(lc.shape[:2], dtype=torch.bool)
    if n_moe:
        # the MoE layer is the last: a flip touches only its own token
        held_served = ~route_flips(f"{arch}: card vs CPU prefill and decode", ref_calls,
                                   calls, n_moe, 2, cfg.moe.top_k)[:, prompt - 1:]
    errs = (lg - lc).abs().amax(-1)[held_served]
    limit = max(1e-3, 4 * rechunk)
    routed = (f" ({int(held.sum())} of {held.numel()} forward and {int(held_served.sum())} "
              f"of {held_served.numel()} served logits held)") if n_moe else ""
    check(err <= limit and errs.max().item() <= 1e-3,
          f"{arch}: card vs CPU (fp32, full width; cut: {cut}): forward {err:.3e} <= "
          f"max(1e-3, 4 x rechunk {rechunk:.3e}) = {limit:.3e}, prefill/decode "
          f"{errs.max().item():.3e} <= 1e-3{routed}")


# ---------------------------------------------------------------------------
# the train path
# ---------------------------------------------------------------------------

def expected_train_launches(cfg, microbatches: int, remat: str) -> dict:
    """Kernel launches per optimizer step: per microbatch, one flash forward
    (LSE entry) and one flash backward per attention layer, one RMSNorm
    forward and backward per norm (ln1, ln2, and the final norm); with remat
    on, the recompute in the backward pass runs each layer's forwards again."""
    fwd, _ = expected_launches(cfg)
    again = 0 if remat == "none" else 1
    n_norm_layers = fwd["rmsnorm"] - 1
    return {"flash_attention": microbatches * fwd["flash_attention"] * (1 + again),
            "flash_attention_bwd": microbatches * fwd["flash_attention"],
            "rmsnorm": microbatches * (fwd["rmsnorm"] + again * n_norm_layers),
            "rmsnorm_bwd": microbatches * fwd["rmsnorm"], "ssd": 0}


def _batch(torch, ds, step: int) -> dict:
    return {k: torch.from_numpy(v).cuda() for k, v in ds.batch(step).items()}


def train_path(torch) -> tuple[dict, dict]:
    """TRAIN_STEPS AdamW steps of smollm-360m at full width and depth through
    make_train_step: 8 x 2048 tokens in 2 microbatches, bf16 compute, fp32
    masters and m/v, TrainConfig defaults but warmup 2 and 8 total steps,
    batches from SyntheticLM. Checks the launches of every step and finite
    losses, then replays one step from a saved state and checks the bits."""
    from repro_torch.config import ParallelConfig, TrainConfig, get_arch
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models import Model
    from repro_torch.train import adamw_init, make_train_step
    from repro_torch.train.optimizer import AdamState, tree_leaves, tree_map

    counters = _counters()
    cfg = get_arch("smollm-360m")
    t0 = time.perf_counter()
    model = Model(cfg, ParallelConfig(remat="none"), device="cuda", seed=0)
    tcfg = TrainConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                       microbatches=TRAIN_BATCH // TRAIN_MB, warmup_steps=2,
                       total_steps=TRAIN_STEPS)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                global_batch=TRAIN_BATCH, seed=0))
    params = model.params_tree()
    state = adamw_init(params)
    step = make_train_step(model, tcfg)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"train {cfg.name}: {cfg.num_layers} layers, {n_params} parameters, "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens in {tcfg.microbatches} microbatches, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    per_step = expected_train_launches(cfg, tcfg.microbatches, "none")
    batches = [_batch(torch, ds, s) for s in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    totals = {n: 0 for n in counters}
    walls, losses, saved = [], [], None
    for s in range(TRAIN_STEPS):
        if s == REPLAY_STEP:
            saved = (tree_map(torch.clone, params), tree_map(torch.clone, state.m),
                     tree_map(torch.clone, state.v), state.step.clone())
        before = {n: fn.launches for n, fn in counters.items()}
        lse_before = flash_attention.lse_launches
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, state, metrics = step(params, state, batches[s])
        loss = metrics["loss"].item()
        walls.append((time.perf_counter() - t1) * 1e3)
        losses.append(loss)
        got = {n: fn.launches - before[n] for n, fn in counters.items()}
        for n in counters:
            totals[n] += got[n]
        check(got == per_step and flash_attention.lse_launches - lse_before
              == per_step["flash_attention"],
              f"train step {s + 1}: launches {got} == {per_step} (flash forwards all "
              f"through the LSE entry)")
        check(math.isfinite(loss) and math.isfinite(metrics["grad_norm"].item()),
              f"train step {s + 1}: loss {loss:.4f}, grad_norm "
              f"{metrics['grad_norm'].item():.4f}, lr {metrics['lr'].item():.3e}, "
              f"wall {walls[-1]:.1f} ms")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = dict(totals)
    warm = sorted(walls[1:])
    step_ms = warm[len(warm) // 2]
    e2e = {"step_wall_ms": step_ms, "step_wall_samples_ms": walls,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
           "peak_memory_gb": peak_gb, "losses": losses}
    print(f"train {cfg.name} end to end ({TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
          f"{tcfg.microbatches} microbatches; median of the {len(warm)} warm steps): "
          f"step {step_ms:.1f} ms [{warm[0]:.1f}, {warm[-1]:.1f}], "
          f"{e2e['tokens_per_s']:.0f} tokens/s, peak memory {peak_gb:.2f} GB", flush=True)

    # replay: the step from the saved (params, m, v, step) gives the same bits
    after = [t.clone() for t in tree_leaves(params)]
    p0, m0, v0, s0 = saved
    params = tree_map(lambda dst, src: dst.copy_(src), params, p0)
    state = AdamState(m=m0, v=v0, step=s0)
    model.params_changed()
    for s in range(REPLAY_STEP, TRAIN_STEPS):
        params, state, metrics = step(params, state, batches[s])
    same = all(torch.equal(a, b) for a, b in zip(after, tree_leaves(params)))
    check(metrics["loss"].item() == losses[-1] and same,
          f"train replay: steps {REPLAY_STEP + 1}-{TRAIN_STEPS} from the saved state give "
          f"the same loss ({metrics['loss'].item():.6f}) and the same parameter bits")
    del saved, after, p0, m0, v0

    run = lambda: step(params, state, batches[0])   # noqa: E731
    run()                                           # warm
    e2e["profile"] = profile_call(torch, run, cfg.name, "train step")
    del params, state, model, batches
    torch.cuda.empty_cache()
    return launches, e2e


# ---------------------------------------------------------------------------
# the supervised train path (§6.1 fault-tolerant pretraining)
# ---------------------------------------------------------------------------

SUPERVISED_PATH = "supervised train smollm-360m"
# Steps, checkpoint period, faults (step -> failure type), the data steps
# whose recorded loss gets SPIKE_DELTA (far above the detector's threshold,
# ~18 at this width), and the free disk the checkpoints need under build/
# (keep=2 plus one .tmp of a 4.34 GB state).
SUP_STEPS, SUP_CKPT_EVERY = 16, 4
SUP_FAULTS = {6: "ConnectionError", 14: "ECCError"}
SUP_SPIKE_STEPS, SUP_SPIKE_DELTA = (10, 11, 12), 100.0
SUP_DISK_GB = 16.0


def supervised_train_path(torch, card: str) -> tuple[dict, dict]:
    """The Supervisor runs ``repro_torch.launch.train.Trainer.job`` on
    smollm-360m at full width and depth, with train_path's TrainConfig (16
    total steps) and batches: checkpoints every 4 steps (keep 2, 2 RAM
    slots) under build/, a ConnectionError at step 6 (no cordon: resume from
    the RAM cache), a loss spike on data steps 10-12 (rollback and skip) and
    an ECCError at step 14 (cordon: drain the persists, resume from the
    newest step on disk). Checks the report, the launches (steps executed x
    per step; a restore launches nothing), and that a second Trainer run
    without faults, its loader skipping what the last attempt skipped, ends
    with the same losses and the same bits. Times save_async's stall, one
    save_sync, and restores of the final step from the RAM cache and from
    disk, each into a zeroed state, which must come back with its bits."""
    import shutil

    from repro_torch.config import ParallelConfig, TrainConfig, get_arch
    from repro_torch.core.ft.checkpoint import CheckpointManager
    from repro_torch.core.ft.detection import SimulatedFleet
    from repro_torch.core.ft.diagnosis import FailureDiagnosisSystem
    from repro_torch.core.ft.events import BY_NAME
    from repro_torch.core.ft.supervisor import JobContext, Supervisor
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.train import Trainer
    from repro_torch.models import Model
    from repro_torch.train.optimizer import tree_leaves

    t_phase = time.perf_counter()
    root = ROOT / "build" / "supervised_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free_gb = shutil.disk_usage(root).free / 1e9
    check(free_gb >= SUP_DISK_GB, f"supervised train: {free_gb:.1f} GB free under build/ "
          f">= {SUP_DISK_GB:.0f} GB for the checkpoints")
    counters = _counters()
    cfg = get_arch("smollm-360m")
    tcfg = TrainConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                       microbatches=TRAIN_BATCH // TRAIN_MB, warmup_steps=2,
                       total_steps=SUP_STEPS)

    def trainer(name: str, **kw):
        model = Model(cfg, ParallelConfig(remat="none"), device="cuda", seed=0)
        ckpt = CheckpointManager(str(root / name), keep=2, ram_cache_slots=2)
        return Trainer(model, tcfg, ckpt, total_steps=SUP_STEPS, log_every=1, **kw)

    sup_trainer = trainer("supervised", ckpt_every=SUP_CKPT_EVERY,
                          fault_schedule={s: BY_NAME[n] for s, n in SUP_FAULTS.items()},
                          spike_schedule={d: SUP_SPIKE_DELTA for d in SUP_SPIKE_STEPS})
    ckpt = sup_trainer.ckpt
    state = (sup_trainer.params, sup_trainer.opt)
    state_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(state))
    attempts = []          # (context, steps in the RAM cache, steps on disk) per attempt

    def job(ctx):
        attempts.append((ctx, sorted(ckpt.ram_cache), ckpt.available_steps()))
        return sup_trainer.job(ctx)

    per_step = expected_train_launches(cfg, tcfg.microbatches, "none")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    report = Supervisor(ckpt, FailureDiagnosisSystem(), SimulatedFleet(8)).run(job)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counters.items()}
    lse = flash_attention.lse_launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ckpt.wait(timeout=600)
    executed = len(sup_trainer.history)
    events = [{"kind": e.kind, "step": e.step, "resumed_from": e.resumed_from,
               "lost_steps": e.lost_steps, "truth": e.truth,
               "diagnosis": e.diagnosis.failure if e.diagnosis else None}
              for e in report.events]
    for e, (ctx, ram, disk) in zip(events, attempts):
        print(f"supervised train attempt from step {ctx.start_step} (RAM cache {ram}, "
              f"disk {disk}, skip {ctx.skip_ranges}) -> {e}", flush=True)
    check(report.completed and report.final_step == SUP_STEPS
          and report.diagnosis_accuracy == 1.0 and not ckpt._errors,
          f"supervised train: completed at step {report.final_step} in {report.attempts} "
          f"attempts, diagnosis accuracy {report.diagnosis_accuracy}, "
          f"persist errors {ckpt._errors}")
    kinds = [e["kind"] for e in events]
    check(kinds == ["failure", "spike", "failure", "done"],
          f"supervised train: events {kinds} == failure, spike, failure, done")
    conn, spike, ecc = report.events[:3]
    onset = min(s for s, loss in sup_trainer.history if loss > SUP_SPIKE_DELTA)
    check(conn.truth == "ConnectionError" and conn.resumed_from in attempts[1][1]
          and attempts[1][0].start_step == conn.resumed_from,
          f"supervised train: the ConnectionError at step {conn.step} resumes from step "
          f"{conn.resumed_from}, in the RAM cache {attempts[1][1]}")
    check(spike.resumed_from <= onset and attempts[2][0].skip_ranges,
          f"supervised train: the spike (onset step {onset}, detected at {spike.step}) "
          f"resumes from step {spike.resumed_from} <= onset, skipping data "
          f"{attempts[2][0].skip_ranges}")
    check(ecc.truth == "ECCError" and ecc.diagnosis.needs_node_cordon
          and ecc.resumed_from == max(attempts[3][2]),
          f"supervised train: the ECCError at step {ecc.step} (cordon) resumes from step "
          f"{ecc.resumed_from}, the newest on disk {attempts[3][2]}")
    want = {n: executed * per_step[n] for n in counters}
    check(launches == want and lse == want["flash_attention"],
          f"supervised train: launches {launches} == {executed} steps executed x {per_step}")

    # the blocking stall of save_async (in the run), one save_sync, and
    # restores of the final state from the RAM cache and from disk, each
    # into a zeroed state and held to a copy of the final state
    stalls_ms = [stall * 1e3 for _, stall in sup_trainer.stalls]
    final = SUP_STEPS
    check(final in ckpt.ram_cache and final in ckpt.available_steps(),
          f"supervised train: step {final} in the RAM cache and on disk")
    kept = [t.clone() for t in tree_leaves(state)]

    def timed_restore() -> float:
        for t in tree_leaves(state):
            t.zero_()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ckpt.restore(final, state)
        torch.cuda.synchronize()
        return (time.perf_counter() - t1) * 1e3

    restore_ram_ms = timed_restore()
    from_ram = all(torch.equal(a, b) for a, b in zip(tree_leaves(state), kept))
    ckpt.ram_cache.clear()
    restore_disk_ms = timed_restore()
    from_disk = all(torch.equal(a, b) for a, b in zip(tree_leaves(state), kept))
    del kept
    check(from_ram and from_disk,
          f"supervised train: step {final} restored into a zeroed state from the RAM cache "
          f"({from_ram}) and from disk ({from_disk}) gives its bits")
    sync_ms = ckpt.save_sync(final + 1, state) * 1e3
    ckpt.close()
    print(f"supervised train checkpoints of one {state_bytes / 1e9:.2f} GB state "
          f"({card}): save_async stall {', '.join(f'{x:.1f}' for x in stalls_ms)} ms; "
          f"save_sync {sync_ms:.1f} ms; restore from the RAM cache {restore_ram_ms:.1f} ms, "
          f"from disk {restore_disk_ms:.1f} ms (the files just written: the host's page "
          f"cache may hold them)", flush=True)

    # exactness: an uninterrupted run, its loader skipping what the last
    # attempt skipped, gives the same losses and the same bits
    skips = attempts[-1][0].skip_ranges
    ref = trainer("uninterrupted", ckpt_every=10 ** 9)
    t1 = time.perf_counter()
    ref.job(JobContext(start_step=0, attempt=0, skip_ranges=skips, healthy_nodes=8,
                       resume_extra={}))
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t1
    ref.ckpt.close()
    last = dict(sup_trainer.history)
    same_loss = [s for s, _ in ref.history] == list(range(1, SUP_STEPS + 1)) and \
        all(last[s] == loss for s, loss in ref.history)
    same_bits = all(torch.equal(a, b) for a, b in zip(
        tree_leaves((sup_trainer.params, sup_trainer.opt)), tree_leaves((ref.params, ref.opt))))
    check(same_loss and same_bits,
          f"supervised train: an uninterrupted run skipping data {skips} gives the same "
          f"loss at every step (last {ref.history[-1][1]:.6f}) and the same bits of "
          f"parameters, m, v and step")
    del sup_trainer, ref, state, ckpt
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    e2e = {"card": card, "steps": SUP_STEPS, "steps_executed": executed, "events": events,
           "state_bytes": state_bytes, "save_async_stall_ms": stalls_ms,
           "save_sync_ms": sync_ms,
           "restore_ram_ms": restore_ram_ms,
           "restore_disk_ms": restore_disk_ms, "supervised_run_s": run_s,
           "uninterrupted_run_s": ref_s, "phase_s": phase_s, "peak_memory_gb": peak_gb}
    print(f"supervised train {cfg.name} ({card}): {executed} steps executed for "
          f"{SUP_STEPS} in {run_s:.1f} s, the uninterrupted run {ref_s:.1f} s, "
          f"peak memory {peak_gb:.2f} GB, phase {phase_s:.1f} s", flush=True)
    return launches, e2e


def profile_call(torch, fn, name: str, phase: str, top_n: int = 8) -> dict:
    """The unprofiled wall time of one call of ``fn``, then torch.profiler
    over another: device busy time (sum of kernel durations on the one
    stream), idle share, launches, and the kernels that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_kernel: dict[str, float] = {}
    launches = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        elif e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx"):
            launches += 1
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top_n]
    out = {"wall_ms": wall_ms, "device_busy_ms": busy, "launches": launches,
           "idle_share": max(0.0, 1.0 - busy / wall_ms),
           "top": [(k[:60], v) for k, v in top]}
    print(f"time {name} {phase}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
          f"(idle share {out['idle_share']:.3f}), {launches} launches", flush=True)
    for k, v in top:
        print(f"    {v:9.3f} ms  {k[:90]}", flush=True)
    return out


def _adam_update(torch, m, v, step: int, tcfg):
    """m_hat / (sqrt(v_hat) + eps) in fp64, from one framework's m and v."""
    m, v = m.double().cpu(), v.double().cpu()
    return (m / (1 - tcfg.adam_b1 ** step)) / (
        torch.sqrt(v / (1 - tcfg.adam_b2 ** step)) + tcfg.adam_eps)


def check_train_card_vs_cpu(torch) -> None:
    """One train step of smollm-360m at full width, 2 layers, fp32, from the
    same weights on the card (kernels) and on the CPU (plain versions),
    2 x 256 tokens in 2 microbatches; then remat "full" against "none" on
    the card.

    Held as tests/test_torch_train.py holds the port against JAX: the loss
    and gradient norm to 1e-5 relative; m and v per element to 1e-5 of the
    leaf's largest |value| (the two sides differ by fp32 summation order;
    main() turns TF32 off); each parameter to 1e-5 of the leaf's largest
    |value| plus lr times the difference of the AdamW updates each side's
    own m and v imply (Adam divides by sqrt(v) + eps, so a gradient near
    eps or below, where summation order moves it by its own size, moves its
    parameter by up to lr). Remat: the same bits in bf16, and the recompute's
    launches."""
    from repro_torch.config import ParallelConfig, TrainConfig, get_arch
    from repro_torch.models import Model
    from repro_torch.train import adamw_init, make_train_step
    from repro_torch.train.optimizer import tree_leaves

    cfg = dataclasses.replace(get_arch("smollm-360m"), num_layers=2, dtype="float32")
    tcfg = TrainConfig(global_batch=2, seq_len=256, microbatches=2, learning_rate=1e-3,
                       warmup_steps=2, total_steps=8)
    toks = torch.randint(0, cfg.vocab_size, (2, 257), generator=torch.Generator().manual_seed(6),
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for dev in ("cpu", "cuda"):
        model = Model(cfg, ParallelConfig(remat="none"), device=dev, seed=1)
        params = model.params_tree()
        state = adamw_init(params)
        params, state, met = make_train_step(model, tcfg)(
            params, state, {k: t.to(dev) for k, t in batch.items()})
        out[dev] = (met, [tree_leaves(x) for x in (params, state.m, state.v)])
    (mc, (pc, mmc, vc)), (mg, (pg, mmg, vg)) = out["cpu"], out["cuda"]
    loss_err = abs(mg["loss"].item() - mc["loss"].item()) / abs(mc["loss"].item())
    norm_err = abs(mg["grad_norm"].item() - mc["grad_norm"].item()) / mc["grad_norm"].item()
    mv_worst = max(((g.cpu() - c).abs().max() / c.abs().max()).item()
                   for g, c in zip(mmg + vg, mmc + vc))
    lr = mc["lr"].item()
    p_worst = 0.0
    for g, c, m1, v1, m2, v2 in zip(pg, pc, mmg, vg, mmc, vc):
        du = (_adam_update(torch, m1, v1, 1, tcfg) - _adam_update(torch, m2, v2, 1, tcfg)).abs()
        limit = 1e-5 * c.abs().max().double() + 1.001 * lr * du
        d = (g.cpu().double() - c.double()).abs()
        p_worst = max(p_worst, (d / limit).max().item())
    check(loss_err <= 1e-5 and norm_err <= 1e-5 and mv_worst <= 1e-5 and p_worst <= 1.0,
          f"train card vs CPU (fp32, full width, 2 layers, one step): loss {loss_err:.2e}, "
          f"grad_norm {norm_err:.2e} <= 1e-5 relative; m, v max |d|/max|ref| "
          f"{mv_worst:.2e} <= 1e-5; parameters worst |d|/limit {p_worst:.3f} <= 1")
    del out, pc, mmc, vc, pg, mmg, vg

    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    res = {}
    for remat in ("none", "full"):
        model = Model(cfg16, ParallelConfig(remat=remat), device="cuda", seed=1)
        params = model.params_tree()
        state = adamw_init(params)
        reset_counters()
        params, state, met = make_train_step(model, tcfg)(
            params, state, {k: t.cuda() for k, t in batch.items()})
        torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in _counters().items()}
        want = expected_train_launches(cfg16, tcfg.microbatches, remat)
        check(launches == want, f"train remat {remat} (2 layers): launches {launches} == {want}")
        res[remat] = [met["loss"]] + tree_leaves((params, state.m, state.v))
    check(all(torch.equal(a, b) for a, b in zip(res["none"], res["full"])),
          "train remat full against none (bf16, 2 layers): the same bits")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this file: {e}",
              file=sys.stderr)
        return 2

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    try:
        with phase("build"):
            t0 = time.perf_counter()
            build.build_all()
            print(f"built CUDA kernels in {time.perf_counter() - t0:.1f} s", flush=True)
            report_build()
        rows = []
        for check_kernel in (check_flash, check_flash_bwd, check_rmsnorm, check_rmsnorm_bwd,
                             check_ssd):
            with phase(check_kernel.__name__):
                res = check_kernel(torch)
                rows.extend(res if isinstance(res, list) else [res])
        with phase("check_flash_backward_raises"):
            check_flash_backward_raises(torch)
        torch.cuda.empty_cache()
        register_deepseek_cut()
        launches, e2e = {}, {}
        for arch in SERVED:       # one session per arch, reused by its checks
            with phase(f"serve {arch}"):
                launches[arch], sess, e2e[arch], seq = serve_path(torch, arch)
            with phase(f"cache parity {arch}"):
                check_cache_parity(torch, arch, sess, seq)
            if sess.cfg.moe.num_experts:
                with phase(f"moe gather vs dense {arch}"):
                    check_moe_gather_vs_dense(torch, sess)
            with phase(f"profile {arch}"):
                e2e[arch]["profile"] = where_the_time_goes(torch, sess)
            del sess, seq
            torch.cuda.empty_cache()
        with phase(TRAIN_PATH):
            launches[TRAIN_PATH], e2e[TRAIN_PATH] = train_path(torch)
        with phase(SUPERVISED_PATH):
            launches[SUPERVISED_PATH], e2e[SUPERVISED_PATH] = supervised_train_path(torch,
                                                                                    card)
        for arch in (*ARCHS, DEEPSEEK):
            with phase(f"card vs CPU {arch}"):
                check_card_vs_cpu(torch, arch)
        with phase("train card vs CPU"):
            check_train_card_vs_cpu(torch)
    except CheckFailed:
        return 1
    print(f"all phases in {time.perf_counter() - t_start:.1f} s", flush=True)
    for row in rows:             # a row counts its wrapper's launches on its paths
        counter = row.pop("counter", row["name"])
        paths = row.pop("paths", (*SERVED, TRAIN_PATH, SUPERVISED_PATH))
        row["launches_by_path"] = {path: launches[path][counter] for path in paths}
        row["launches"] = sum(row["launches_by_path"].values())
    print(json.dumps({"end_to_end": e2e}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
