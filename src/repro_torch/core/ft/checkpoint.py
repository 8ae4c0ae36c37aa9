"""Asynchronous checkpointing of torch trees (paper §6.1, design 1).

The paper's observation: host memory is abundant (<50% used, Fig. 7b) while
TB-scale synchronous checkpoints stall training up to 43%. The fix: snapshot
device state into host RAM (the only part that blocks the training loop),
then persist to (remote) storage from a background thread.

This module implements:
  * ``CheckpointManager.save_async``  — blocking cost = device->host snapshot
  * ``CheckpointManager.save_sync``   — baseline: snapshot + serialize + write
  * in-RAM checkpoint cache (Gemini-style fast restore path)
  * atomic on-disk commit (tmp dir + rename; manifest written last)
  * in-place restore: leaves are written into the template's own tensors,
    on their device, so a restore allocates no second state on the card
  * optional storage-bandwidth throttle modelling a contended remote PFS
    (the paper's all-NVMe shared parallel FS with a 25 Gb/s storage NIC)

The port of ``repro.core.ft.checkpoint``: everything but the snapshot and the
restore is the same code. Leaves are taken in the JAX package's order
(:func:`repro_torch.train.optimizer.tree_leaves`: dict keys sorted, then
lists and tuples in order, so ``(params, AdamState(m, v, step))`` flattens
as the JAX package's ``(params, AdamState)`` does) and the layout on disk is
the same, so a checkpoint written by either package restores in the other.
Re-sharding on restore (an elastic restart on another mesh) waits for the
port's device mesh (ROADMAP Queue 1 item 12).

State layout on disk::

    <dir>/step_00001230/
        manifest.json     # leaf count, shapes/dtypes, extra state, committed
        leaf_000000.npy ...

Tree *structure* comes from code (model.specs() + optimizer template), only
leaf data lives in storage — standard production practice.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.train.optimizer import tree_leaves
from repro_torch.utils import logger

Params = Any


def _host_copy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            # numpy has no bfloat16; an upcast would change the manifest
            raise TypeError("cannot checkpoint a bfloat16 tensor: numpy has "
                            "no bfloat16")
        # a copy even on the CPU, where .cpu() would return the tensor
        # itself and the next in-place optimizer step would change the
        # RAM cache under it
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _snapshot(tree: Params) -> list[np.ndarray]:
    """Device -> host copy of all leaves. This is the only training stall."""
    return [_host_copy(l) for l in tree_leaves(tree)]


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 ram_cache_slots: int = 2,
                 storage_bandwidth_gbps: Optional[float] = None):
        self.dir = directory
        self.keep = keep
        self.ram_cache_slots = ram_cache_slots
        self.bw = storage_bandwidth_gbps          # None = unthrottled
        self.ram_cache: dict[int, tuple[list[np.ndarray], dict]] = {}
        self._q: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self._worker = threading.Thread(target=self._persist_loop, daemon=True)
        self._worker.start()
        self._inflight = 0
        self._lock = threading.Lock()
        self._errors: list[str] = []
        self._malformed_warned: set[str] = set()
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save_async(self, step: int, state: Params,
                   extra: Optional[dict] = None) -> float:
        """Snapshot to host RAM and return; persistence happens in the
        background. Returns the blocking (stall) time in seconds."""
        t0 = time.perf_counter()
        leaves = _snapshot(state)
        stall = time.perf_counter() - t0
        extra = dict(extra or {})
        self._cache_put(step, leaves, extra)
        with self._lock:
            self._inflight += 1
        self._q.put((step, leaves, extra))
        return stall

    def save_sync(self, step: int, state: Params,
                  extra: Optional[dict] = None) -> float:
        """Baseline synchronous checkpoint. Returns total blocking time."""
        t0 = time.perf_counter()
        leaves = _snapshot(state)
        self._cache_put(step, leaves, dict(extra or {}))
        self._write(step, leaves, dict(extra or {}))
        return time.perf_counter() - t0

    def wait(self, timeout: float = 300.0) -> None:
        """Drain in-flight background persists."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._lock:
                if self._inflight == 0:
                    return
            time.sleep(0.005)
        raise TimeoutError("checkpoint persist queue did not drain")

    # -- restore ------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = self.available_steps()
        return steps[-1] if steps else None

    def latest_restorable(self) -> Optional[int]:
        """Newest step restorable from RAM cache *or* disk.

        The RAM cache is the Gemini-style fast path: a snapshot that has not
        finished persisting yet is still perfectly good for an in-place
        restart (process survived, node didn't fail)."""
        steps = set(self.available_steps()) | set(self.ram_cache)
        return max(steps) if steps else None

    def available_steps(self) -> list[int]:
        if not os.path.isdir(self.dir):
            return []
        out = []
        for name in os.listdir(self.dir):
            if not name.startswith("step_") or name.endswith(".tmp"):
                continue
            # stray entries ("step_final", "step_12_copy", editor litter)
            # must not poison the scan — skip anything whose suffix is not
            # a plain integer step number
            suffix = name[len("step_"):]
            if not suffix.isdigit():
                if name not in self._malformed_warned:
                    self._malformed_warned.add(name)
                    logger.warning("ignoring malformed checkpoint entry %r",
                                   name)
                continue
            manifest = os.path.join(self.dir, name, "manifest.json")
            if os.path.exists(manifest):
                out.append(int(suffix))
        return sorted(out)

    def restore(self, step: int, template: Params) -> tuple[Params, dict]:
        """Load leaves (RAM cache first, then disk) into ``template``'s own
        tensors, in place and on their device, and return ``template``.

        Each leaf is copied in, so the template never shares memory with the
        RAM cache: an in-place optimizer step after a restore leaves the
        cached snapshot as it was. Re-sharding for an elastic restart (the
        reference's ``shardings`` argument) waits for the port's device mesh
        (ROADMAP Queue 1 item 12)."""
        if step in self.ram_cache:
            leaves, extra = self.ram_cache[step]
            logger.info("checkpoint %d restored from RAM cache", step)
        else:
            path = self._step_dir(step)
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
            leaves = [np.load(os.path.join(path, f"leaf_{i:06d}.npy"))
                      for i in range(manifest["num_leaves"])]
            extra = manifest.get("extra", {})
        flat_t = tree_leaves(template)
        if len(flat_t) != len(leaves):
            raise ValueError(f"leaf count mismatch: template {len(flat_t)} vs "
                             f"ckpt {len(leaves)}")
        with torch.no_grad():
            for i, (dst, leaf) in enumerate(zip(flat_t, leaves)):
                if not isinstance(dst, torch.Tensor):
                    raise TypeError(f"leaf {i}: the template's leaves must be "
                                    f"tensors, got {type(dst).__name__}")
                if tuple(dst.shape) != leaf.shape:
                    raise ValueError(f"leaf {i}: shape {leaf.shape} in the "
                                     f"checkpoint, {tuple(dst.shape)} in the template")
                dst.copy_(torch.from_numpy(leaf))
        return template, extra

    # -- internals ----------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def _cache_put(self, step: int, leaves, extra) -> None:
        self.ram_cache[step] = (leaves, extra)
        while len(self.ram_cache) > self.ram_cache_slots:
            del self.ram_cache[min(self.ram_cache)]

    def _persist_loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            step, leaves, extra = item
            try:
                self._write(step, leaves, extra)
            except Exception as e:  # noqa: BLE001 — background thread
                self._errors.append(f"step {step}: {e!r}")
                logger.error("checkpoint persist failed: %s", e)
            finally:
                with self._lock:
                    self._inflight -= 1

    def _write(self, step: int, leaves: list[np.ndarray],
               extra: dict) -> None:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        total = 0
        t0 = time.perf_counter()
        for i, leaf in enumerate(leaves):
            np.save(os.path.join(tmp, f"leaf_{i:06d}.npy"), leaf)
            total += leaf.nbytes
        if self.bw is not None:
            # model a contended remote PFS: bytes / (Gb/s -> B/s)
            want = total / (self.bw * 1e9 / 8)
            slept = want - (time.perf_counter() - t0)
            if slept > 0:
                time.sleep(slept)
        manifest = {
            "step": step,
            "num_leaves": len(leaves),
            "total_bytes": total,
            "shapes": [list(l.shape) for l in leaves],
            "dtypes": [str(l.dtype) for l in leaves],
            "extra": extra,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.available_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def close(self) -> None:
        self._q.put(None)
        self._worker.join(timeout=10)
