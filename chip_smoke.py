"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

  python3 chip_smoke.py

Builds the port's kernels from the sources in this checkout (one ``nvcc``
per CUDA source, all started together), holds each one against its plain
PyTorch version on the card (the flash-attention and RMSNorm backward
kernels too, each with a negative control), then drives three paths at full
width and depth (random weights from a seed):

  * serving, through ``repro_torch.launch.serve.ServeSession``: smollm-360m
    (flash attention, RMSNorm) and mamba2-1.3b (SSD scan, RMSNorm). For each
    it checks the launch counts, the token stream, the cache against a full
    forward, and the card against the CPU;
  * training, through ``repro_torch.train.make_train_step``: 8 AdamW steps
    of smollm-360m, 8 x 2048 tokens in 2 microbatches (flash attention and
    RMSNorm forward and backward). It checks the launches of every step,
    finite losses, a bit-exact replay of a step from a saved state, one step
    of a 2-layer model on the card against the CPU, and remat against none.

It prints:

  * the card's name and power limit (``nvidia-smi``), the build time, and
    per CUDA kernel its registers, shared memory and spills (``nvcc -Xptxas
    -v``) and counts of the SASS opcodes that show its design (wgmma, TMA,
    mbarrier, mma.sync, cp.async, ldmatrix; ``cuobjdump -sass``),
  * one line per check, the end-to-end prefill/decode tokens/s (median of
    warm repeats), the train step's wall, tokens/s and peak memory, and a
    torch.profiler breakdown of one prefill, eight decode steps and one
    train step (device busy time, launches, top kernels),
  * a JSON line ``{"end_to_end": {path: ...}}``,
  * a JSON line ``{"kernels": [...]}`` with each kernel's launches on the
    three paths (``launches``, their sum, and ``launches_by_path``), error,
    time, plain time, bound and library time,
  * last, ``{"ok": true, "device": {...}}``.

Exits non-zero, with no result line, if there is no GPU, if the port's
package is not beside this file, or if any check fails.
"""
from __future__ import annotations

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


# ---------------------------------------------------------------------------
# what was built
# ---------------------------------------------------------------------------

# SASS opcodes that show the design in the compiled code: wgmma (HGMMA),
# mma.sync (HMMA), TMA loads (UTMALDG), mbarrier operations (SYNCS), cp.async
# (LDGSTS), ldmatrix (LDSM); and the ones each library must contain
SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "SYNCS", "LDGSTS", "LDSM")
SASS_REQUIRED = {"flash_attention": ("HGMMA", "UTMALDG", "SYNCS"),
                 "flash_attention_bwd": ("HMMA", "LDSM", "LDGSTS"),
                 "ssd": ("HMMA", "LDGSTS")}


def report_build() -> None:
    """Per kernel of each CUDA source: registers, shared memory and spills as
    ``nvcc -Xptxas -v`` printed them, and counts of the SASS opcodes above
    (``cuobjdump -sass``). Fails if a library lacks an opcode its design
    needs."""
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
        sass = subprocess.run([cuobjdump, "-sass", str(build.library(name))],
                              capture_output=True, text=True, timeout=300).stdout
        counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in SASS_OPS}
        print(f"sass {name}: " + ", ".join(f"{op} {n}" for op, n in counts.items()),
              flush=True)
        check(all(counts[op] > 0 for op in SASS_REQUIRED[name]),
              f"{name}: the compiled library contains "
              f"{', '.join(SASS_REQUIRED[name])}")


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


def check_flash(torch) -> dict:
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention
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
    ]
    row = None
    for name, B, Sq, Skv, H, KV, D, dtype, causal, window, softcap in cases:
        q, k, v = _attn_inputs(torch, g, B, Sq, Skv, H, KV, D, dtype,
                               strided=name != "main")
        off = max(Skv - Sq, 0)          # queries sit at the tail of the keys
        qp = torch.arange(off, off + Sq, dtype=torch.int32, device="cuda")
        kp = torch.arange(Skv, dtype=torch.int32, device="cuda")
        if name.endswith("_masked"):    # empty slots and fully masked rows
            kp = kp + 10
            kp[-40:] = -1
            qp = torch.arange(Sq, dtype=torch.int32, device="cuda") - 5
        qp, kp = qp.expand(B, Sq), kp.expand(B, Skv)
        if name == "per_batch_pos":     # row 1's keys 37 later, row 2's queries 50 earlier
            kp = kp + torch.tensor([0, 37, 0], dtype=torch.int32, device="cuda")[:, None]
            qp = qp - torch.tensor([0, 0, 50], dtype=torch.int32, device="cuda")[:, None]
        kw = dict(causal=causal, window=window, softcap=softcap)
        out = flash_attention(q, k, v, qp, kp, **kw)
        ref = flash_attention_ref(q, k, v, qp, kp, **kw)
        if dtype == torch.float32:
            err, worst = excess(out, ref, 1e-4)
            what = "max_abs <= 1e-4"
        else:
            abs_v = flash_attention_ref(q, k, v.abs(), qp, kp, **kw).float()
            err, worst = excess(out, ref, BF16_RTOL * ref.float().abs() + 2.0 ** -8 * abs_v)
            worst = max(worst, err / BF16_MAX_ABS)
            what = "|d| <= 2**-6 |ref| + 2**-8 attn(|v|) and max_abs <= 2e-2"
        check(out.dtype == q.dtype and out.shape == q.shape
              and bool(torch.isfinite(out).all()) and worst <= 1.0,
              f"flash_attention {name}: max_abs_err {err:.3e}, worst |d|/limit "
              f"{worst:.3f} <= 1 ({what})")
        if name.endswith("_masked"):
            dead = out[:, :10].abs().max().item()   # q_pos < 10: nothing visible
            check(dead == 0.0, f"flash_attention fully masked rows are 0 ({dead})")
        if name != "main":
            continue
        ms = time_ms(lambda: flash_attention(q, k, v, qp, kp, **kw))
        plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, qp, kp, **kw), iters=5,
                           rounds=3)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
        # the work these inputs need: 4*D operations per visible (q, kv)
        # pair and head (QK^T and PV); each input read once, output written once
        pairs = _mask(qp[:, :, None], kp[:, None, :], window, causal).sum().item()
        ops = 4 * D * H * pairs
        nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, out, qp, kp))
        bound = max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS["bfloat16"]) * 1e3
        by = "operations" if ops / PEAK_OPS["bfloat16"] > nbytes / HBM_BYTES_PER_S else "bytes"
        print(f"flash_attention main (B={B} S={Sq} H={H} KV={KV} D={D} bf16 causal): "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
              f"bound {bound:.4f} ms ({by}; {ops:.4e} ops, {nbytes} bytes)", flush=True)
        row = {"name": "flash_attention", "route": "cuda",
               "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
               "replaces": "src/repro/kernels/flash_attention/kernel.py:92",
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}
    return row


def check_rmsnorm(torch) -> dict:
    from repro_torch.kernels.rmsnorm import rmsnorm_ref
    from repro_torch.kernels.rmsnorm.ops import rmsnorm

    g = torch.Generator(device="cuda").manual_seed(1)
    # fp32: max-abs <= 1e-5 (summation order). bf16: both sides round the
    # same fp32 value, so per element |d| <= 2**-6 |ref| (see BF16_RTOL),
    # plus 1e-6 for the fp32 noise of elements near 0, and max-abs <= 2e-2
    d = 960
    scale = 0.5 + 0.05 * torch.randn(d, generator=g, device="cuda")
    row = None
    for rows, dtype in [(BATCH * PROMPT, torch.bfloat16), (BATCH * PROMPT, torch.float32),
                        (37, torch.bfloat16), (37, torch.float32), (BATCH, torch.bfloat16)]:
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
        if (rows, dtype) != (BATCH * PROMPT, torch.bfloat16):
            continue
        ms = time_ms(lambda: rmsnorm(x, scale), iters=50)
        plain_ms = time_ms(lambda: rmsnorm_ref(x, scale), iters=50)
        nbytes = 2 * x.numel() * x.element_size() + scale.numel() * 4
        ops = 4 * x.numel() + rows          # square, add, 2 multiplies; rsqrt
        bound = max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS["float32"]) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / PEAK_OPS["float32"] else "operations"
        print(f"rmsnorm main ({rows}, {d}) bf16: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}; {nbytes} bytes)", flush=True)
        # library_ms: none. No single PyTorch call computes this function:
        # F.rms_norm wants its weight in x's dtype and does not compute in
        # fp32 with an fp32 scale on bf16 rows.
        row = {"name": "rmsnorm", "route": "triton",
               "source": "src/repro_torch/kernels/rmsnorm/kernel.py",
               "replaces": "src/repro/kernels/rmsnorm/kernel.py:29",
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": by, "library_ms": None}
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
        ms = time_ms(lambda: rmsnorm_bwd(x, scale, dy), iters=50)
        plain_ms = time_ms(lambda: rmsnorm_bwd_ref(x, scale, dy), iters=20)
        nbytes = 3 * x.numel() * x.element_size() + 2 * d * 4   # x, dy, dx; scale, dscale
        ops = 10 * x.numel() + rows
        bound = max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS["float32"]) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / PEAK_OPS["float32"] else "operations"
        print(f"rmsnorm_bwd main ({rows}, {d}) bf16: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}; {nbytes} bytes)", flush=True)
        # library_ms: none, as for the forward: no single PyTorch call takes
        # an fp32 scale on bf16 rows
        row = {"name": "rmsnorm_bwd", "route": "triton",
               "source": "src/repro_torch/kernels/rmsnorm/kernel.py",
               # autodiff of the JAX package's layers.rmsnorm (no Pallas VJP)
               "replaces": "src/repro/models/layers.py:28",
               "max_abs_err": max(err, serr), "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": by, "library_ms": None}
    return row


# ---------------------------------------------------------------------------
# the slice end to end
# ---------------------------------------------------------------------------

ARCHS = ("smollm-360m", "mamba2-1.3b")
TRAIN_PATH = "train smollm-360m"


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
    RMSNorm for ln1, for ln2 where there is an MLP, for mamba's gated norm,
    and once for the final norm, in both. Serving launches no backward."""
    from repro_torch.models.model import layer_plans
    plans = layer_plans(cfg)
    norms = 1 + sum(1 + (p.mlp != "none") + (p.mixer == "mamba") for p in plans)
    prefill = {"flash_attention": sum(p.mixer == "attn" for p in plans),
               "ssd": sum(p.mixer == "mamba" for p in plans), "rmsnorm": norms,
               "flash_attention_bwd": 0, "rmsnorm_bwd": 0}
    return prefill, dict(prefill, flash_attention=0, ssd=0)


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
    t0 = time.perf_counter()
    sess = ServeSession(arch)
    cfg = sess.cfg
    print(f"ServeSession {arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.dtype}, built in {time.perf_counter() - t0:.1f} s", flush=True)
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
    e2e = {"prefill_tokens_per_s": sorted(prefill)[len(prefill) // 2],
           "decode_tokens_per_s": sorted(decode)[len(decode) // 2],
           "prefill_samples": prefill, "decode_samples": decode}
    print(f"{arch} end to end (B={BATCH}, prompt {PROMPT}, {GEN} steps; median "
          f"of {REPEATS}): prefill {e2e['prefill_tokens_per_s']:.1f} tokens/s "
          f"[{min(prefill):.1f}, {max(prefill):.1f}], decode "
          f"{e2e['decode_tokens_per_s']:.1f} tokens/s [{min(decode):.1f}, "
          f"{max(decode):.1f}]", flush=True)
    seq = torch.cat([batch["tokens"], gen], dim=1)
    return launches, sess, e2e, seq


def _parity_errors(model, seq, *, zero_cache=False) -> tuple[list, object]:
    """max |logits error| of prefill(seq[:, :PROMPT]) and of each decode step
    against one full forward of ``seq``; and that forward's logits. With
    ``zero_cache``, every floating-point cache leaf is zeroed after the
    prefill: a fault the check must catch."""
    import torch
    full = model.forward_logits({"tokens": seq}).float()
    logits, caches = model.prefill({"tokens": seq[:, :PROMPT]},
                                   max_cache_len=seq.shape[1])
    errs = [(logits.float() - full[:, PROMPT - 1]).abs().max().item()]
    if zero_cache:
        with torch.no_grad():
            for seg in caches:
                for layer in seg:
                    for leaves in layer.values():
                        for t in leaves.values():
                            if t.is_floating_point():
                                t.zero_()
    for t in range(PROMPT, seq.shape[1]):
        logits, caches = model.decode_step(caches, seq[:, t], t)
        errs.append((logits.float() - full[:, t]).abs().max().item())
    return errs, full


def check_cache_parity(torch, arch, sess, seq) -> None:
    """Prefill + decode logits against one full forward of the sequence:
    the kernels over all tokens on one side; the kernels over the prompt,
    then the plain decode (attention over the ring cache, or the SSM
    recurrence) on the other. The same rule for every arch, on the prompt
    and GEN seeded random tokens (greedy decoding of random weights repeats
    one token, and rounding drift piles up there).

      * fp32, the session's weights at full width and depth: max |err| <=
        2**-10 of the largest |logit|. The two sides differ by fp32
        summation order: on an H100, smollm read 1.6e-5 against 0.0107 and
        mamba 2.4e-3 against 0.0094. The same run with every cache leaf zeroed after the prefill
        must exceed the limit: the check fails a lost state, conv tail or
        KV cache at this depth.
      * bf16, the session itself, is a smoke check and not evidence of a
        right cache: limit max(0.25, 2 e), e being the largest distance
        between the bf16 and the fp32 full forwards over the same positions.
        In mamba's 48 layers bf16 rounding alone moves logits by O(1) (e ~3
        at max |logit| ~10), as large as a cache fault."""
    from repro_torch.models import Model
    g = torch.Generator().manual_seed(5)
    tail = torch.randint(0, sess.cfg.vocab_size, (seq.shape[0], seq.shape[1] - PROMPT),
                         generator=g, dtype=seq.dtype)
    seq = torch.cat([seq[:, :PROMPT], tail.to(seq.device)], dim=1)
    errs, full = _parity_errors(sess.model, seq)
    m32 = Model(dataclasses.replace(sess.cfg, dtype="float32"), device=sess.device,
                seed=sess._seed)                   # the session's weights
    errs32, full32 = _parity_errors(m32, seq)
    broken, _ = _parity_errors(m32, seq, zero_cache=True)
    del m32
    scale = full32.abs().max().item()
    limit = 2.0 ** -10 * scale
    noise = (full[:, PROMPT - 1:] - full32[:, PROMPT - 1:]).abs().max().item()
    check(max(errs32) <= limit and bool(torch.isfinite(full32).all()),
          f"{arch}: cache parity (fp32, full width and depth): max_abs logits "
          f"err {max(errs32):.3e} <= 2**-10 max|logit| = {limit:.4e} over "
          f"prefill + {len(errs32) - 1} steps")
    check(max(broken[1:]) > limit,
          f"{arch}: cache parity fails a zeroed cache: max_abs logits err "
          f"{max(broken[1:]):.3e} > {limit:.4e} over {len(broken) - 1} steps")
    print(f"{arch}: cache parity errors by step (bf16): "
          f"{' '.join(f'{e:.3f}' for e in errs)}", flush=True)
    check(max(errs) <= max(0.25, 2 * noise) and bool(torch.isfinite(full).all()),
          f"{arch}: cache parity (bf16 smoke check, not evidence): max_abs "
          f"logits err {max(errs):.4f} <= max(0.25, 2 x {noise:.4f}), {noise:.4f} "
          f"being bf16 against fp32 in the full forward (max |logit| {scale:.2f})")


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
    chunks of 256, the last ragged).

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

    prompt, cache_len = (64, 128) if arch == "smollm-360m" else (600, 0)
    cfg = dataclasses.replace(get_arch(arch), num_layers=2, dtype="float32")
    cpu = Model(cfg, device="cpu", seed=1)
    gpu = Model(cfg, device="cuda", seed=2)
    gpu.load_params(cpu.params_tree())
    toks = torch.randint(0, cfg.vocab_size, (2, prompt + 8),
                         generator=torch.Generator().manual_seed(3), dtype=torch.int32)
    ref = cpu.forward_logits({"tokens": toks})
    out = gpu.forward_logits({"tokens": toks.cuda()}).cpu()
    err = (out - ref).abs().max().item()
    rechunk = 0.0
    if cfg.ssm is not None:
        half = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, chunk_size=cfg.ssm.chunk_size // 2))
        other = Model(half, device="cpu", seed=2)
        other.load_params(cpu.params_tree())
        rechunk = (other.forward_logits({"tokens": toks}) - ref).abs().max().item()
        del other
    lc, cc = cpu.prefill({"tokens": toks[:, :prompt]}, max_cache_len=cache_len)
    lg, cg = gpu.prefill({"tokens": toks[:, :prompt].cuda()}, max_cache_len=cache_len)
    errs = [(lg.cpu() - lc).abs().max().item()]
    for t in range(prompt, prompt + 8):
        lc, cc = cpu.decode_step(cc, toks[:, t], t)
        lg, cg = gpu.decode_step(cg, toks[:, t].cuda(), t)
        errs.append((lg.cpu() - lc).abs().max().item())
    limit = max(1e-3, 4 * rechunk)
    check(err <= limit and max(errs) <= 1e-3,
          f"{arch}: card vs CPU (fp32, 2 layers): forward {err:.3e} <= "
          f"max(1e-3, 4 x rechunk {rechunk:.3e}) = {limit:.3e}, prefill/decode "
          f"{max(errs):.3e} <= 1e-3")


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
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    try:
        t0 = time.perf_counter()
        build.build_all()
        print(f"built CUDA kernels in {time.perf_counter() - t0:.1f} s", flush=True)
        report_build()
        rows = [check_flash(torch), check_flash_bwd(torch), check_rmsnorm(torch),
                check_rmsnorm_bwd(torch), check_ssd(torch)]
        torch.cuda.empty_cache()
        launches, e2e = {}, {}
        for arch in ARCHS:
            launches[arch], sess, e2e[arch], seq = serve_path(torch, arch)
            check_cache_parity(torch, arch, sess, seq)
            e2e[arch]["profile"] = where_the_time_goes(torch, sess)
            del sess, seq
            torch.cuda.empty_cache()
        launches[TRAIN_PATH], e2e[TRAIN_PATH] = train_path(torch)
        for arch in ARCHS:
            check_card_vs_cpu(torch, arch)
        check_train_card_vs_cpu(torch)
    except CheckFailed:
        return 1
    for row in rows:
        row["launches_by_path"] = {path: launches[path][row["name"]]
                                   for path in (*ARCHS, TRAIN_PATH)}
        row["launches"] = sum(row["launches_by_path"].values())
    print(json.dumps({"end_to_end": e2e}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
