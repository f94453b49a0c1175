"""Architecture registry: ``get(arch_id)`` -> config module with FULL / SMOKE.

mamba2-1.3b, llama3.2-1b, qwen3-moe-235b-a22b, grok-1-314b, zamba2-2.7b
and internvl2-76b are ported so far; the reference's other architectures
are listed so that asking for one names the plan instead of failing
obscurely.
"""
from __future__ import annotations

import importlib

ARCHS = {"mamba2-1.3b": "mamba2_1_3b", "llama3.2-1b": "llama3_2_1b",
         "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
         "grok-1-314b": "grok_1_314b", "zamba2-2.7b": "zamba2_2_7b",
         "internvl2-76b": "internvl2_76b"}

NOT_PORTED = (
    "internlm2-20b", "deepseek-67b", "h2o-danube-3-4b",
    "seamless-m4t-medium",
)


def get(arch: str):
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to PyTorch yet; the order of the "
            "remaining architectures is in ROADMAP.md")
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
