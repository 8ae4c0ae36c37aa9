"""PyTorch/CUDA port of ``repro``'s accelerator half, for one NVIDIA H100.

Module names follow the JAX package so each counterpart is easy to find. The
port imports neither JAX nor anything of ``repro``: it keeps its own copies
of what it needs. Its entry points run on the card unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper uses its plain version.
"""
from repro_torch.config import get_arch, get_smoke, list_archs
from repro_torch.models import Model

__all__ = ["Model", "get_arch", "get_smoke", "list_archs"]
