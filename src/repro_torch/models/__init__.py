"""Model zoo of the port: the dense (llama), vlm (internvl2), moe (qwen3-moe,
grok-1), ssm (mamba2) and hybrid (zamba2) families."""
from repro_torch.models.layers import ModelConfig
from repro_torch.models.lm import Bundle, build_lm

__all__ = ["Bundle", "ModelConfig", "build_lm"]
