"""Architecture registry: ``get(arch_id)`` -> config module with FULL /
SMOKE / SHAPES / SKIPS / OPT_STATE_DTYPE (and OPTIMIZER where it is not
AdamW).

Every architecture of the reference is here, in the reference's order
(``repro.configs.ARCHS``): zamba2-2.7b, qwen3-moe-235b-a22b, grok-1-314b,
internvl2-76b, llama3.2-1b, internlm2-20b, deepseek-67b, h2o-danube-3-4b,
mamba2-1.3b and seamless-m4t-medium.
"""
from __future__ import annotations

import importlib

ARCHS = {
    "zamba2-2.7b": "zamba2_2_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "grok-1-314b": "grok_1_314b",
    "internvl2-76b": "internvl2_76b",
    "llama3.2-1b": "llama3_2_1b",
    "internlm2-20b": "internlm2_20b",
    "deepseek-67b": "deepseek_67b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "mamba2-1.3b": "mamba2_1_3b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}


def get(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def all_arch_ids() -> list[str]:
    return list(ARCHS)
