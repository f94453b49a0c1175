from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline

__all__ = ["DataConfig", "SyntheticLMPipeline"]
