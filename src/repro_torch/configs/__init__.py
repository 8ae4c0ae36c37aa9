"""Architecture registry: importing this package registers every ported
``--arch <id>``. Each module defines ``build()`` (the published config) and
``smoke()`` (a reduced same-family config that runs on the CPU). Only the
archs whose layers the port implements are registered: the two of the
first serving slices, the five dense archs of the zoo, and its three MoE
archs (deepseek-v2-lite-16b with MLA, mixtral-8x22b, jamba-1.5-large-398b).
The encoder-decoder and VLM archs follow with ROADMAP Queue 1 item 11.
"""
from repro_torch.configs import (deepseek_v2_lite_16b, gemma3_27b,  # noqa: F401
                                 h2o_danube_1_8b, internlm_7b, internlm_123b,
                                 jamba_1_5_large_398b, mamba2_1_3b, mixtral_8x22b,
                                 nemotron_4_15b, smollm_360m)
