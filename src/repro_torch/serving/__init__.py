"""Serving on the port: the wave scheduler with greedy sampling."""
from repro_torch.serving.engine import (
    Request,
    Result,
    ServeConfig,
    ServingEngine,
)

__all__ = ["Request", "Result", "ServeConfig", "ServingEngine"]
