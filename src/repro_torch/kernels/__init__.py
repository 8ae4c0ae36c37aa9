"""Hand-written Hopper kernels of the port, each beside its plain version.

Importing this package neither imports ``triton`` nor builds anything: the
CUDA libraries are built and the Triton kernel compiled at the first launch
on a CUDA tensor.
"""
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
from repro_torch.kernels.ssd import ssd, ssd_ref

__all__ = ["flash_attention", "flash_attention_ref", "rmsnorm", "rmsnorm_ref",
           "ssd", "ssd_ref"]
