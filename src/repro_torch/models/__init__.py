"""Model zoo of the port: the ssm family (mamba2) so far."""
from repro_torch.models.layers import ModelConfig
from repro_torch.models.lm import Bundle, build_lm

__all__ = ["Bundle", "ModelConfig", "build_lm"]
