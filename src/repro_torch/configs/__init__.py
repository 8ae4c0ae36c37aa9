"""Architecture registry: importing this package registers every ported
``--arch <id>``. Each module defines ``build()`` (the published config) and
``smoke()`` (a reduced same-family config that runs on the CPU). Only the
archs whose layers the port implements are registered; the others follow
with later slices.
"""
from repro_torch.configs import mamba2_1_3b, smollm_360m  # noqa: F401
