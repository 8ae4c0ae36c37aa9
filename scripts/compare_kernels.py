"""Time this checkout's backward kernels against an earlier version's, on one
NVIDIA H100, in one process, interleaved.

  git archive <commit> src/repro_torch | tar -x -C build/old
  python3 scripts/compare_kernels.py --old build/old [--sweep] [--variant X.cu ...]

``--old`` is the root of a tree that holds the earlier ``src/repro_torch``.
From it the script builds the earlier flash-attention backward source with
the same ``nvcc`` flags (its C entry ``flash_attention_bwd`` has the same
arguments) and imports the earlier RMSNorm Triton module. Then, at the train
path's shapes (flash: B=4 S=2048 H=15 KV=5 D=64 bf16 causal; RMSNorm:
(8192, 960) bf16 with an fp32 scale):

  * the earlier and the current flash backward, timed in turns (earlier,
    current, current, earlier, earlier, current), each a median of CUDA-event
    rounds as ``chip_smoke.time_ms`` takes it; their dq, dk, dv compared;
    each profiled once (``chip_smoke.profile_call``: its launches by name);
  * the earlier RMSNorm backward under ``chip_smoke.profile_call``, which
    lists its launches (the row pass and the column sum) with their device
    times, the current one likewise, then both versions timed in turns, with
    ``F.rms_norm``'s autograd backward beside them;
  * with ``--sweep``, the current RMSNorm backward at other launch shapes
    (rows per block and warps in place of the module's ``_bwd_shape``,
    pipeline stages and programs per SM in place of its ``BWD_STAGES`` and
    ``BWD_PER_SM``), each checked against the plain version first;
  * with ``--variant``, other flash-attention backward sources (the same C
    entry; a header they include is looked for beside them), each checked
    against the current kernel and timed in turns with it.

Prints the card's name and power limit first. Needs the card.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (time_ms, profile_call, excess, limits)


def _flash_bwd_entry(src: Path, tag: str):
    """ctypes entry of another flash backward source, built like the current."""
    from repro_torch.kernels import build
    out = build.BUILD_DIR / f"libflash_attention_bwd-{tag}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stdout}{res.stderr}")
    spills = [line.strip() for line in res.stdout.splitlines() + res.stderr.splitlines()
              if "spill" in line or "C75" in line]
    print(f"built {src.name} ({tag}): " + "; ".join(sorted(set(spills))), flush=True)
    fn = ctypes.CDLL(str(out)).flash_attention_bwd
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P] * 12 + [I] * 9 + [F, F, P]
    fn.restype = ctypes.c_int
    return fn


def _old_rmsnorm(old: Path):
    path = old / "src/repro_torch/kernels/rmsnorm/kernel.py"
    spec = importlib.util.spec_from_file_location("rmsnorm_kernel_old", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def turns(torch, label: str, fns: dict, **kw) -> None:
    """Time the callables in turns, forward, backward and forward again (a b
    b a a b for two), and print every reading."""
    order = [*fns, *reversed(fns), *fns]
    got = {name: [] for name in fns}
    for name in order:
        got[name].append(chip_smoke.time_ms(fns[name], **kw))
    for name, ts in got.items():
        print(f"{label} {name}: " + ", ".join(f"{t:.4f}" for t in ts) + " ms", flush=True)


def flash(torch, old: Path, variants: list[Path]) -> None:
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd_cuda
    entries = {"earlier": _flash_bwd_entry(
        old / "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu", "earlier")}
    for i, src in enumerate(variants):
        entries[src.stem] = _flash_bwd_entry(src, f"variant{i}")
    g = torch.Generator(device="cuda").manual_seed(3)
    B, S, H, KV, D = 4, 2048, 15, 5, 64
    q, k, v = chip_smoke._attn_inputs(torch, g, B, S, S, H, KV, D, torch.bfloat16)
    dout = torch.randn((B, S, H, D), generator=g, device="cuda").to(torch.bfloat16)
    pos = torch.arange(S, dtype=torch.int32, device="cuda").expand(B, S).contiguous()
    out, lse = flash_attention_ref(q, k, v, pos, pos, return_lse=True)
    kw = dict(causal=True, window=0, softcap=0.0)

    def launcher(fn):
        def call():
            dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
            delta = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     dout.data_ptr(), lse.data_ptr(), pos.data_ptr(), pos.data_ptr(),
                     dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), B, S, S,
                     H, KV, D, 1, 1, 0, D ** -0.5, 0.0, torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
            return dq, dk, dv
        return call

    calls = {name: launcher(fn) for name, fn in entries.items()}
    calls["current"] = lambda: flash_attention_bwd_cuda(q, k, v, out, lse, dout, pos, pos,
                                                        **kw)
    mine = calls["current"]()
    for name, call in calls.items():
        diffs = [(a.float() - b.float()).abs().max().item() for a, b in zip(call(), mine)]
        print(f"flash_attention_bwd {name} vs current: max |d| dq {diffs[0]:.3e}, "
              f"dk {diffs[1]:.3e}, dv {diffs[2]:.3e}", flush=True)
    turns(torch, "flash_attention_bwd (B=4 S=2048 H=15 KV=5 D=64 bf16 causal)", calls,
          iters=10, sleep_per_iter=2_000_000)
    for name, call in calls.items():
        chip_smoke.profile_call(torch, call, f"flash_attention_bwd {name}", "one call",
                                top_n=4)


def rmsnorm(torch, old: Path, sweep: bool) -> None:
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_ref
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_bwd_triton
    mod = _old_rmsnorm(old)
    g = torch.Generator(device="cuda").manual_seed(4)
    rows, d = 8192, 960
    scale = 0.5 + 0.05 * torch.randn(d, generator=g, device="cuda")
    x = torch.randn((rows, d), generator=g, device="cuda").to(torch.bfloat16)
    dy = torch.randn((rows, d), generator=g, device="cuda").to(torch.bfloat16)
    earlier = lambda: mod.rmsnorm_bwd_triton(x, scale, dy, 1e-5)   # noqa: E731
    earlier()
    chip_smoke.profile_call(torch, earlier, "rmsnorm_bwd earlier (8192, 960) bf16",
                            "one call", top_n=4)
    rdx, rds = rmsnorm_bwd_ref(x, scale, dy)
    x32 = x.float()
    a = (dy.float() * x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-5)).abs().sum(0)

    def within(dx, ds) -> float:
        return max(chip_smoke.excess(dx, rdx, chip_smoke.BF16_RTOL * rdx.float().abs() + 1e-6)[1],
                   chip_smoke.excess(ds, rds, 1e-5 * a)[1])

    current = lambda: rmsnorm_bwd_triton(x, scale, dy, 1e-5)       # noqa: E731
    print(f"rmsnorm_bwd current: worst |d|/limit {within(*current()):.3f}", flush=True)
    chip_smoke.profile_call(torch, current, "rmsnorm_bwd current (8192, 960) bf16",
                            "one call", top_n=4)
    xr = x.detach().requires_grad_(True)
    sr = scale.detach().requires_grad_(True)
    y = torch.nn.functional.rms_norm(xr, (d,), sr, 1e-5)
    library = lambda: torch.autograd.grad(y, (xr, sr), dy, retain_graph=True)  # noqa: E731
    turns(torch, "rmsnorm_bwd (8192, 960) bf16", {"earlier": earlier, "current": current},
          iters=50)
    print(f"rmsnorm_bwd F.rms_norm autograd: "
          f"{chip_smoke.time_ms(library, iters=50, sleep_per_iter=2_000_000):.4f} ms",
          flush=True)
    if not sweep:
        return
    from repro_torch.kernels.rmsnorm import kernel
    chosen = kernel._bwd_shape, kernel.BWD_STAGES, kernel.BWD_PER_SM
    for rows, warps, stages, per_sm in [
            (1, 2, 3, 4), (1, 4, 3, 4), (2, 2, 3, 4), (2, 4, 2, 4), (2, 4, 3, 4),
            (2, 4, 4, 4), (2, 4, 3, 3), (2, 4, 3, 2), (4, 4, 2, 2), (4, 4, 3, 2),
            (4, 4, 4, 2), (4, 4, 3, 3), (4, 8, 3, 1), (8, 8, 2, 1), (8, 8, 3, 1),
            (8, 4, 2, 2)]:
        kernel._bwd_shape = lambda d, triton, w=warps, r=rows: (triton.next_power_of_2(d), w, r)
        kernel.BWD_STAGES, kernel.BWD_PER_SM = stages, per_sm
        worst = within(*current())
        print(f"rmsnorm_bwd sweep rows {rows} warps {warps} stages {stages} per_sm "
              f"{per_sm}: {chip_smoke.time_ms(current, iters=50):.4f} ms, worst |d|/limit "
              f"{worst:.3f}", flush=True)
    kernel._bwd_shape, kernel.BWD_STAGES, kernel.BWD_PER_SM = chosen


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="root of a tree holding the earlier src/repro_torch")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the RMSNorm backward at other launch shapes")
    ap.add_argument("--variant", type=Path, nargs="*", default=[],
                    help="other flash-attention backward sources to time beside the current")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    from repro_torch.kernels import build
    build.build_all()
    flash(torch, args.old, args.variant)
    rmsnorm(torch, args.old, args.sweep)
    return 0


if __name__ == "__main__":
    sys.exit(main())
