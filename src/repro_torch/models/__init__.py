"""Model zoo of the port: the dense (llama, internlm2, deepseek,
h2o-danube), vlm (internvl2), moe (qwen3-moe, grok-1), ssm (mamba2) and
hybrid (zamba2) families of the decoder-only LM, and the encoder-decoder
(seamless-m4t). :func:`build` picks between the two, as the reference's."""
from repro_torch.models.layers import ModelConfig
from repro_torch.models.lm import Bundle, build_lm


def build(cfg: ModelConfig) -> Bundle:
    if cfg.family == "encdec":
        from repro_torch.models.encdec import build_encdec

        return build_encdec(cfg)
    return build_lm(cfg)


__all__ = ["Bundle", "ModelConfig", "build", "build_lm"]
