"""Architecture registry: importing this package registers every ported
``--arch <id>``. Each module defines ``build()`` (the published config) and
``smoke()`` (a reduced same-family config that runs on the CPU). Only the
archs whose layers the port implements are registered: the two of the
serving slices and the five dense archs of the zoo. The others (MoE, MLA,
encoder-decoder, VLM) follow with later slices.
"""
from repro_torch.configs import (gemma3_27b, h2o_danube_1_8b,  # noqa: F401
                                 internlm_7b, internlm_123b, mamba2_1_3b,
                                 nemotron_4_15b, smollm_360m)
