"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

  python3 chip_smoke.py

Builds the port's kernels from the sources in this checkout, holds each one
against its plain PyTorch version on the card, serves smollm-360m at full
width and depth through ``repro_torch.launch.serve.ServeSession`` (random
weights from a seed), checks the launch counts, the token stream, the cache
against a full forward, and the card against the CPU, and prints:

  * the card's name and power limit (``nvidia-smi``),
  * one line per check, the end-to-end prefill/decode tokens/s (median of
    warm repeats), and a torch.profiler breakdown of one prefill and eight
    decode steps (device busy time, launches, top kernels),
  * a JSON line ``{"kernels": [...]}`` with each kernel's launches on the
    main path, error, time, plain time, bound and library time,
  * last, ``{"ok": true, "device": {...}}``.

Exits non-zero, with no result line, if there is no GPU, if the port's
package is not beside this file, or if any check fails.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and operations/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}

# Prompt batch and decode length of the main path; warm timed repeats.
BATCH, PROMPT, GEN = 4, 1024, 32
REPEATS = 5


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    print(("PASS " if cond else "FAIL ") + what, flush=True)
    if not cond:
        raise CheckFailed(what)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call, from CUDA events around ``iters`` calls.

    A sleep kernel first keeps the stream busy while the host enqueues the
    calls, so the events time the calls back to back and not the host's
    launch overhead."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(iters * 200_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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
    its limit when the second is <= 1."""
    d = (out.float() - ref.float()).abs()
    return d.max().item(), (d / limit).max().item()


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
    ]
    row = None
    for name, B, Sq, Skv, H, KV, D, dtype, causal, window, softcap in cases:
        q, k, v = _attn_inputs(torch, g, B, Sq, Skv, H, KV, D, dtype,
                               strided=name != "main")
        off = max(Skv - Sq, 0)          # queries sit at the tail of the keys
        qp = torch.arange(off, off + Sq, dtype=torch.int32, device="cuda")
        kp = torch.arange(Skv, dtype=torch.int32, device="cuda")
        if name == "fp32_masked":       # empty slots and fully masked rows
            kp = kp + 10
            kp[-40:] = -1
            qp = torch.arange(Sq, dtype=torch.int32, device="cuda") - 5
        qp, kp = qp.expand(B, Sq), kp.expand(B, Skv)
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
        if name == "fp32_masked":
            dead = out[:, :10].abs().max().item()   # q_pos < 10: nothing visible
            check(dead == 0.0, f"flash_attention fully masked rows are 0 ({dead})")
        if name != "main":
            continue
        ms = time_ms(lambda: flash_attention(q, k, v, qp, kp, **kw))
        plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, qp, kp, **kw), iters=5)
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


# ---------------------------------------------------------------------------
# the slice end to end
# ---------------------------------------------------------------------------

def serve_main_path(torch) -> tuple[dict, object, dict, torch.Tensor]:
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.launch.serve import ServeSession

    t0 = time.perf_counter()
    sess = ServeSession("smollm-360m")
    cfg = sess.cfg
    print(f"ServeSession smollm-360m: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.dtype}, built in {time.perf_counter() - t0:.1f} s", flush=True)
    batch = sess.make_batch(BATCH, PROMPT, seed=0)

    flash_attention.launches = 0
    rmsnorm.launches = 0
    sess.prefill(batch)
    gen, _ = sess.decode_step(GEN)
    torch.cuda.synchronize()
    launches = {"flash_attention": flash_attention.launches,
                "rmsnorm": rmsnorm.launches}
    n_layers, per_fwd = cfg.num_layers, 2 * cfg.num_layers + 1
    check(launches["flash_attention"] == n_layers,
          f"flash_attention launches {launches['flash_attention']} == {n_layers} per prefill")
    check(launches["rmsnorm"] == per_fwd * (1 + GEN),
          f"rmsnorm launches {launches['rmsnorm']} == {per_fwd} x (prefill + {GEN} steps)")
    check(gen.shape == (BATCH, GEN) and int(gen.min()) >= 0
          and int(gen.max()) < cfg.padded_vocab,
          f"generated tokens {tuple(gen.shape)} in [0, {cfg.padded_vocab})")
    kv = sess._caches[0][0]["kv"]["k"]
    print(f"KV cache: {kv.shape[2]} slots x {cfg.num_layers} layers, "
          f"{2 * kv.numel() * kv.element_size() / 1e9:.2f} GB", flush=True)

    # again, warm, in two decode calls: the stream must be contiguous
    tp = sess.prefill(batch)
    a, td1 = sess.decode_step(GEN // 2)
    b, td2 = sess.decode_step(GEN - GEN // 2)
    check(torch.equal(torch.cat([a, b], dim=1), gen),
          "two decode_step calls continue one token stream")
    prefill = [tp.tokens_per_s]
    decode = [BATCH * GEN / (td1.seconds + td2.seconds)]
    for _ in range(REPEATS - 1):
        prefill.append(sess.prefill(batch).tokens_per_s)
        decode.append(sess.decode_step(GEN)[1].tokens_per_s)
    e2e = {"prefill_tokens_per_s": sorted(prefill)[len(prefill) // 2],
           "decode_tokens_per_s": sorted(decode)[len(decode) // 2],
           "prefill_samples": prefill, "decode_samples": decode}
    print(f"end to end (B={BATCH}, prompt {PROMPT}, {GEN} steps; median of "
          f"{REPEATS}): prefill {e2e['prefill_tokens_per_s']:.1f} tokens/s "
          f"[{min(prefill):.1f}, {max(prefill):.1f}], decode "
          f"{e2e['decode_tokens_per_s']:.1f} tokens/s [{min(decode):.1f}, "
          f"{max(decode):.1f}]", flush=True)
    seq = torch.cat([batch["tokens"], gen], dim=1)
    return launches, sess, e2e, seq


def check_cache_parity(torch, sess, seq) -> None:
    """Prefill + decode logits against one full forward of the sequence: the
    flash kernel on one side, plain decode attention over the ring cache on
    the other. Tolerance: bf16 rounding through 32 layers, measured at about
    0.1 on this shape; 0.25 leaves room and still fails on a wrong cache
    slot, position or mask, which moves logits by O(1)."""
    model = sess.model
    full = model.forward_logits({"tokens": seq}).float()
    logits, caches = model.prefill({"tokens": seq[:, :PROMPT]})
    errs = [(logits.float() - full[:, PROMPT - 1]).abs().max().item()]
    for t in range(PROMPT, seq.shape[1]):
        logits, caches = model.decode_step(caches, seq[:, t], t)
        errs.append((logits.float() - full[:, t]).abs().max().item())
    del caches
    check(max(errs) <= 0.25 and bool(torch.isfinite(full).all()),
          f"cache parity (bf16, full width): max_abs logits err {max(errs):.4f} "
          f"<= 0.25 over prefill + {len(errs) - 1} steps")


def where_the_time_goes(torch, sess) -> dict:
    """torch.profiler over one warm prefill and 8 decode steps: device busy
    time (sum of kernel durations on the one stream), launches, and the
    kernels that take most of it, beside the unprofiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = sess.make_batch(BATCH, PROMPT, seed=0)
    out = {}
    for name, fn in [("prefill", lambda: sess.prefill(batch)),
                     ("decode8", lambda: sess.decode_step(8))]:
        if name == "prefill":
            fn()                                   # warm
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
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
        out[name] = {"wall_ms": wall_ms, "device_busy_ms": busy, "launches": launches,
                     "idle_share": max(0.0, 1.0 - busy / wall_ms),
                     "top": [(k[:60], v) for k, v in top]}
        print(f"time {name}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
              f"(idle share {out[name]['idle_share']:.3f}), {launches} launches", flush=True)
        for k, v in top:
            print(f"    {v:9.3f} ms  {k[:90]}", flush=True)
    return out


def check_card_vs_cpu(torch) -> None:
    """Full width, 2 layers, fp32, same weights: card (kernels) vs CPU
    (plain versions). fp32 differs only by summation order, ~1e-5 here
    (main() turns TF32 off for matrix products on the card)."""
    from repro_torch.config import get_arch
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_arch("smollm-360m"), num_layers=2, dtype="float32")
    cpu = Model(cfg, device="cpu", seed=1)
    gpu = Model(cfg, device="cuda", seed=2)
    gpu.load_params(cpu.params_tree())
    toks = torch.randint(0, cfg.vocab_size, (2, 96), generator=torch.Generator().manual_seed(3),
                         dtype=torch.int32)
    ref = cpu.forward_logits({"tokens": toks})
    out = gpu.forward_logits({"tokens": toks.cuda()}).cpu()
    err = (out - ref).abs().max().item()
    lc, cc = cpu.prefill({"tokens": toks[:, :64]}, max_cache_len=128)
    lg, cg = gpu.prefill({"tokens": toks[:, :64].cuda()}, max_cache_len=128)
    errs = [(lg.cpu() - lc).abs().max().item()]
    for t in range(64, 72):
        lc, cc = cpu.decode_step(cc, toks[:, t], t)
        lg, cg = gpu.decode_step(cg, toks[:, t].cuda(), t)
        errs.append((lg.cpu() - lc).abs().max().item())
    check(err <= 1e-3 and max(errs) <= 1e-3,
          f"card vs CPU (fp32, 2 layers): forward {err:.3e}, prefill/decode "
          f"{max(errs):.3e} <= 1e-3")


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
        build.load("flash_attention")
        print(f"built CUDA kernels in {time.perf_counter() - t0:.1f} s", flush=True)
        rows = [check_flash(torch), check_rmsnorm(torch)]
        launches, sess, e2e, seq = serve_main_path(torch)
        check_cache_parity(torch, sess, seq)
        e2e["profile"] = where_the_time_goes(torch, sess)
        del sess
        torch.cuda.empty_cache()
        check_card_vs_cpu(torch)
    except CheckFailed:
        return 1
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"end_to_end": e2e}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
