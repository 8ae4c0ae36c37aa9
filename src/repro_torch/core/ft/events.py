"""Failure taxonomy from paper Table 3 + synthetic runtime-log generation.

Every failure type carries the paper's measured statistics (occurrences,
GPU demand, time-to-failure, restart cost, % of lost GPU time) and realistic
log templates. The generator emits *cascades* — a root cause plus secondary
symptom errors (the paper: "a job might fail with messages that include
NCCLTimeoutError, CUDAError and multiple kinds of RuntimeError, whereas the
root cause is CUDAError") — which is exactly what makes naive rule matching
inaccurate and motivates the agent-based diagnosis.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Optional

INFRA, FRAMEWORK, SCRIPT = "Infrastructure", "Framework", "Script"


@dataclasses.dataclass(frozen=True)
class FailureType:
    name: str
    category: str
    # paper Table 3 statistics
    num: int
    gpu_demand_avg: float
    ttf_avg_mins: float        # time to failure
    ttf_median_mins: float
    gpu_time_pct: float        # share of lost GPU time
    restart_avg_mins: float
    # diagnosis machinery
    templates: tuple[str, ...] # root-cause log lines ({} slots randomized)
    secondary: tuple[str, ...] = ()  # cascade symptom names
    needs_node_cordon: bool = False  # triggers the two-round NCCL test
    auto_recoverable: bool = True    # restart-from-ckpt fixes it
    priority: int = 0                # higher wins when multiple errors coexist


TABLE3: tuple[FailureType, ...] = (
    # --- Infrastructure ----------------------------------------------------
    FailureType("NVLinkError", INFRA, 54, 800, 868.1, 155.3, 30.25, 95.6,
                ("NVLink Error: fatal error detected on link {d} (GPU {d})",
                 "torch.distributed: NCCL watchdog caught NVLink failure on rank {d}"),
                secondary=("NCCLTimeoutError", "RuntimeError"),
                needs_node_cordon=True, priority=90),
    FailureType("CUDAError", INFRA, 21, 847, 923.2, 586.0, 15.77, 78.3,
                ("CUDA error: an illegal memory access was encountered at device {d}",
                 "CUDA error: uncorrectable ECC error encountered (kernel launch)",
                 "RuntimeError: CUDA error: device-side assert triggered on rank {d}"),
                secondary=("NCCLTimeoutError", "RuntimeError"),
                needs_node_cordon=True, priority=85),
    FailureType("NodeFailure", INFRA, 16, 712, 1288.8, 535.8, 14.30, 102.8,
                ("slurmstepd: error: Node node-{d} unexpectedly rebooted",
                 "kubelet: node node-{d} became NotReady: heartbeat lost"),
                secondary=("ConnectionError",),
                needs_node_cordon=True, priority=80),
    FailureType("ECCError", INFRA, 12, 680, 1303.4, 1192.3, 11.00, 2.8,
                ("GPU {d}: double-bit ECC error detected, row remapping pending",
                 "XID 48: GPU {d} DBE (double bit error) occurred"),
                secondary=("CUDAError",),
                needs_node_cordon=True, priority=88),
    FailureType("NetworkError", INFRA, 12, 758, 549.6, 310.1, 4.53, 592.1,
                ("ibv_poll_cq failed: transport retry counter exceeded on mlx5_{d}",
                 "RDMA read error: remote access error qp={d}"),
                secondary=("NCCLTimeoutError", "ConnectionError"),
                needs_node_cordon=True, priority=75),
    FailureType("ConnectionError", INFRA, 147, 29, 51.9, 0.5, 3.44, 0.8,
                ("ConnectionError: [Errno 111] Connection refused: metrics.acme.lab:{d}",
                 "requests.exceptions.ConnectionError: HTTPSConnectionPool host='wandb-proxy'"),
                priority=30),
    FailureType("S3StorageError", INFRA, 10, 422, 2317.8, 202.2, 2.12, 6.2,
                ("botocore.exceptions.EndpointConnectionError: Could not connect to s3://ckpt-bucket/{d}",
                 "S3 upload failed after {d} retries: SlowDown"),
                priority=60),
    FailureType("NCCLTimeoutError", INFRA, 6, 596, 159.7, 48.1, 0.50, 66.7,
                ("NCCL watchdog: collective operation timed out after 1800000ms rank {d}",
                 "torch.distributed.DistBackendError: NCCL timeout in allreduce"),
                needs_node_cordon=True, priority=70),
    FailureType("NCCLRemoteError", INFRA, 3, 1152, 50.5, 22.6, 0.15, 0.0,
                ("NCCL error: remote process exited or there was a network error, rank {d}",),
                needs_node_cordon=True, priority=72),
    # --- Framework ----------------------------------------------------------
    FailureType("DataloaderKilled", FRAMEWORK, 6, 445, 1580.6, 961.4, 4.38, 115.1,
                ("RuntimeError: DataLoader worker (pid {d}) is killed by signal: Killed",
                 "dataloader worker exited unexpectedly, OOM-killer score {d}"),
                priority=55),
    FailureType("AttributeError", FRAMEWORK, 67, 228, 67.8, 1.2, 3.90, 2.4,
                ("AttributeError: 'NoneType' object has no attribute '{w}'",
                 "AttributeError: module 'internevo.model' has no attribute '{w}'"),
                auto_recoverable=False, priority=20),
    FailureType("OutOfMemoryError", FRAMEWORK, 14, 572, 323.8, 14.5, 3.28, 122.7,
                ("torch.cuda.OutOfMemoryError: Tried to allocate {d} GiB (GPU {d}; 79.35 GiB total)",
                 "RESOURCE_EXHAUSTED: Out of memory while trying to allocate {d} bytes"),
                auto_recoverable=False, priority=65),
    FailureType("RuntimeError", FRAMEWORK, 65, 441, 66.4, 3.9, 1.72, 10.9,
                ("RuntimeError: The size of tensor a ({d}) must match the size of tensor b ({d})",
                 "RuntimeError: expected scalar type BFloat16 but found Float"),
                auto_recoverable=False, priority=15),
    FailureType("AssertionError", FRAMEWORK, 105, 413, 41.7, 3.0, 1.24, 185.9,
                ("AssertionError: micro_num % pipeline_parallel_size == 0",
                 "AssertionError: expected checkpoint step {d}, got {d}"),
                auto_recoverable=False, priority=14),
    FailureType("ValueError", FRAMEWORK, 33, 387, 9.9, 3.7, 0.16, 27.4,
                ("ValueError: could not broadcast input array from shape ({d},) into ({d},)",),
                auto_recoverable=False, priority=13),
    FailureType("ZeroDivisionError", FRAMEWORK, 5, 499, 14.5, 15.6, 0.03, 2.5,
                ("ZeroDivisionError: division by zero in loss scaling",),
                auto_recoverable=False, priority=12),
    FailureType("ModelLoadingError", FRAMEWORK, 104, 8, 2.6, 2.6, 0.00, 0.0,
                ("OSError: Unable to load weights from checkpoint {w}.bin: invalid header",),
                auto_recoverable=False, priority=25),
    FailureType("DatasetLoadingError", FRAMEWORK, 5, 1, 1.6, 1.6, 0.00, 0.0,
                ("DatasetGenerationError: failed to parse shard {w}.jsonl line {d}",),
                auto_recoverable=False, priority=24),
    # --- Script -------------------------------------------------------------
    FailureType("FileNotFoundError", SCRIPT, 568, 21, 14.2, 0.4, 2.83, 0.4,
                ("FileNotFoundError: [Errno 2] No such file or directory: '{w}.json'",),
                auto_recoverable=False, priority=10),
    FailureType("OSError", SCRIPT, 266, 8, 9.6, 0.8, 0.28, 0.3,
                ("OSError: [Errno 122] Disk quota exceeded: '{w}.log'",),
                auto_recoverable=False, priority=9),
    FailureType("TypeError", SCRIPT, 620, 18, 0.9, 0.3, 0.06, 0.2,
                ("TypeError: unsupported operand type(s) for +: 'int' and 'str'",
                 "TypeError: {w}() got an unexpected keyword argument '{w}'"),
                auto_recoverable=False, priority=8),
    FailureType("NameError", SCRIPT, 18, 247, 3.2, 0.5, 0.02, 2.9,
                ("NameError: name '{w}' is not defined",),
                auto_recoverable=False, priority=7),
    FailureType("PermissionError", SCRIPT, 7, 438, 4.3, 0.8, 0.01, 2.4,
                ("PermissionError: [Errno 13] Permission denied: '/mnt/petrel/{w}'",),
                auto_recoverable=False, priority=6),
    FailureType("ImportError", SCRIPT, 111, 93, 1.1, 0.4, 0.01, 0.7,
                ("ImportError: cannot import name '{w}' from 'internevo.{w}'",),
                auto_recoverable=False, priority=5),
    FailureType("KeyError", SCRIPT, 260, 7, 3.0, 1.6, 0.01, 0.1,
                ("KeyError: '{w}'",),
                auto_recoverable=False, priority=4),
    FailureType("SyntaxError", SCRIPT, 10, 391, 0.7, 0.6, 0.00, 1.7,
                ("SyntaxError: invalid syntax ({w}.py, line {d})",),
                auto_recoverable=False, priority=3),
    FailureType("ArgumentError", SCRIPT, 3, 344, 0.7, 0.7, 0.00, 2.7,
                ("argparse.ArgumentError: argument --{w}: invalid int value: '{w}'",),
                auto_recoverable=False, priority=2),
    FailureType("CalledProcessError", SCRIPT, 4, 256, 0.2, 0.2, 0.00, 11.7,
                ("subprocess.CalledProcessError: Command '{w}' returned non-zero exit status {d}",),
                auto_recoverable=False, priority=2),
    FailureType("IndexError", SCRIPT, 23, 6, 1.6, 0.9, 0.00, 0.8,
                ("IndexError: list index out of range",),
                auto_recoverable=False, priority=1),
)

BY_NAME: dict[str, FailureType] = {f.name: f for f in TABLE3}

# the Table-3 types whose root cause lives in a node (GPU/NVLink/ECC/...):
# these are what the replay engine's ``hardware`` interruption class
# synthesizes logs from, and what must come back ``needs_node_cordon`` for
# the diagnosis-in-the-loop recovery to pick the cordon/elastic policies
CORDON_TYPES: tuple[str, ...] = tuple(
    f.name for f in TABLE3 if f.needs_node_cordon)


def types_in_category(category: str) -> tuple[FailureType, ...]:
    """All Table-3 failure types of one paper category
    (Infrastructure/Framework/Script)."""
    return tuple(f for f in TABLE3 if f.category == category)

_WORDS = ("config", "scheduler", "tokenizer", "embedding", "optimizer",
          "sampler", "rotary", "partition", "gateway", "collector")

_NORMAL_LINES = (
    "INFO [trainer] step={step} loss={loss:.4f} lr={lr:.2e} grad_norm={gn:.3f} tgs={tgs:.1f}",
    "INFO [trainer] step={step} consumed_tokens={tok} tflops={tf:.1f}",
    "DEBUG [mem] step={step} allocated={mem:.1f}GB reserved={mem2:.1f}GB",
    "INFO [ckpt] async snapshot step={step} stall={ms:.1f}ms",
    "INFO [data] shard rotation: now reading shard {shard}",
)

_INIT_LINES = (
    "INFO [launch] world_size=1024 tp=8 pp=4 dp=32 micro_batch=4",
    "INFO [launch] NCCL version 2.18.3+cuda12.1",
    "INFO [model] InternLM 123B: layers=96 hidden=10240 heads=80",
    "INFO [data] tokenizer loaded: vocab=103168 model=v7_sft.model",
    "INFO [ckpt] resuming from step 41200 (s3://ckpt-bucket/run-17/)",
)

# serving-flavored spam for the serving replay's injected incidents: same
# format keys as the trainer lines (the generate_log loop passes one kwarg
# set either way, so both flavors consume the RNG identically), but shaped
# like an inference engine's heartbeat — batch occupancy, TTFT, KV paging,
# admission — so the diagnosis pipeline sees a serving log, not a trainer's.
_SERVE_NORMAL_LINES = (
    "INFO [serve] step={step} batch_occupancy={gn:.3f} decode_tps={tgs:.1f}",
    "INFO [serve] step={step} kv_pages_resident={tok} prefill_tflops={tf:.1f}",
    "DEBUG [kv] step={step} allocated={mem:.1f}GB paged={mem2:.1f}GB",
    "INFO [admit] ttft_p50={ms:.1f}ms queue_lambda={loss:.4f}",
    "INFO [route] request shard {shard} admitted to decode instance",
)

_SERVE_INIT_LINES = (
    "INFO [serve] disaggregated fleet up: prefill=4 decode=16 gpus/inst=8",
    "INFO [serve] NCCL version 2.18.3+cuda12.1",
    "INFO [model] InternLM 7B serving: layers=32 hidden=4096 heads=32",
    "INFO [kv] paged KV cache: page=16 tokens, 4096 pages/instance",
    "INFO [serve] continuous batching enabled: max_batch=64",
)


def fill_template(template: str, rng: random.Random) -> str:
    """Randomize a log template's ``{d}``/``{w}`` slots."""
    out = template
    while "{d}" in out:
        out = out.replace("{d}", str(rng.randint(0, 4096)), 1)
    while "{w}" in out:
        out = out.replace("{w}", rng.choice(_WORDS), 1)
    return out


_fill = fill_template


def generate_log(failure: Optional[FailureType], *, seed: int = 0,
                 n_normal: int = 400, start_step: int = 41200,
                 cascade: bool = True, flavor: str = "train") -> list[str]:
    """Synthesize a runtime log: init banner + metric spam [+ failure tail].

    With ``cascade=True`` the root cause is buried among secondary symptom
    errors and repeated watchdog spam, mimicking real multi-error logs.
    ``flavor="serve"`` swaps the trainer banner/heartbeat for an inference
    engine's (same failure-tail templates — the §5 hazards are identical);
    both flavors consume the RNG identically, so a given seed yields the
    same root cause and tail ordering either way.
    """
    rng = random.Random(seed)
    init, normal = ((_SERVE_INIT_LINES, _SERVE_NORMAL_LINES)
                    if flavor == "serve" else (_INIT_LINES, _NORMAL_LINES))
    lines = list(init)
    loss = 2.31
    for i in range(n_normal):
        loss = max(1.2, loss - rng.random() * 1e-3)
        t = rng.choice(normal)
        lines.append(t.format(step=start_step + i, loss=loss,
                              lr=2.4e-5, gn=rng.random() * 2,
                              tgs=3900 + rng.random() * 200,
                              tok=(start_step + i) * 4_194_304,
                              tf=180 + rng.random() * 10,
                              mem=62 + rng.random() * 4,
                              mem2=72 + rng.random() * 4,
                              ms=210 + rng.random() * 40,
                              shard=rng.randint(0, 800)))
    if failure is None:
        return lines
    # failure tail: secondaries first (often what floods the log), root
    # cause in the middle, then more secondary spam — worst case for rules.
    tail: list[str] = []
    if cascade:
        for sec_name in failure.secondary:
            sec = BY_NAME.get(sec_name)
            if sec:
                for _ in range(rng.randint(1, 3)):
                    tail.append("ERROR " + _fill(rng.choice(sec.templates), rng))
    tail.append("ERROR " + _fill(rng.choice(failure.templates), rng))
    if cascade:
        for _ in range(rng.randint(2, 6)):
            tail.append("ERROR Traceback (most recent call last):")
            tail.append('ERROR   File "train.py", line %d, in <module>'
                        % rng.randint(100, 900))
        for sec_name in failure.secondary:
            sec = BY_NAME.get(sec_name)
            if sec:
                tail.append("ERROR " + _fill(rng.choice(sec.templates), rng))
    rng.shuffle(tail)  # interleaving across ranks scrambles ordering
    return lines + tail


def sample_failure(rng: random.Random,
                   category: Optional[str] = None) -> FailureType:
    """Draw a failure type with probability proportional to Table 3 counts."""
    pool = [f for f in TABLE3 if category is None or f.category == category]
    weights = [f.num for f in pool]
    return rng.choices(pool, weights=weights, k=1)[0]
