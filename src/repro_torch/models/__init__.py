"""Model zoo of the port: the dense (llama) and ssm (mamba2) families."""
from repro_torch.models.layers import ModelConfig
from repro_torch.models.lm import Bundle, build_lm

__all__ = ["Bundle", "ModelConfig", "build_lm"]
