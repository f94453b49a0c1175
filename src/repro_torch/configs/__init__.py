"""Architecture registry: ``get(arch_id)`` -> config module with FULL / SMOKE.

Every architecture of the reference is here: mamba2-1.3b, llama3.2-1b,
qwen3-moe-235b-a22b, grok-1-314b, zamba2-2.7b, internvl2-76b,
seamless-m4t-medium, internlm2-20b, deepseek-67b and h2o-danube-3-4b.
"""
from __future__ import annotations

import importlib

ARCHS = {"mamba2-1.3b": "mamba2_1_3b", "llama3.2-1b": "llama3_2_1b",
         "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
         "grok-1-314b": "grok_1_314b", "zamba2-2.7b": "zamba2_2_7b",
         "internvl2-76b": "internvl2_76b",
         "seamless-m4t-medium": "seamless_m4t_medium",
         "internlm2-20b": "internlm2_20b", "deepseek-67b": "deepseek_67b",
         "h2o-danube-3-4b": "h2o_danube_3_4b"}


def get(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
