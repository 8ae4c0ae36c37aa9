"""Build the port's CUDA sources at first use and load them with ctypes.

Each source under a kernel's ``csrc/`` is compiled on its own by ``nvcc`` into
a shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), placed in ``build/kernels/`` at the root of the checkout and
named by the hash of the source and the flags: a changed source builds anew,
an unchanged one is loaded as it is. :func:`build_all` starts one ``nvcc``
per source, all together. ``nvcc`` runs with ``-Xptxas -v``; what it prints
(registers, shared memory and spills per kernel) is kept beside the library
and read back by :func:`build_log`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build" / "kernels"
PKG = Path(__file__).resolve().parent

#: every CUDA source of the port, by library name
SOURCES = {
    "flash_attention": PKG / "flash_attention" / "csrc" / "flash_attention.cu",
    "flash_attention_bwd": PKG / "flash_attention" / "csrc" / "flash_attention_bwd.cu",
    "ssd": PKG / "ssd" / "csrc" / "ssd.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def library(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> subprocess.Popen | None:
    """Start ``nvcc`` for one source unless its library exists."""
    target = library(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(name: str, proc: subprocess.Popen | None) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    target = library(name)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n{out}")
    target.with_suffix(".log").write_text(out)
    os.replace(tmp, target)


def build_all() -> None:
    """Build every source that is not built yet, one ``nvcc`` each, all
    started together."""
    procs = {name: _start(name) for name in SOURCES}
    for name, proc in procs.items():
        _finish(name, proc)


def build_log(name: str) -> str:
    """What ``nvcc`` printed when it built this source's library."""
    log = library(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if need be."""
    lib = _LOADED.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = _LOADED[name] = ctypes.CDLL(str(library(name)))
    return lib
