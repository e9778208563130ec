"""Serving layer of the port: the single-device ``QueryEngine``."""
from repro_torch.serve.engine import EngineConfig, QueryEngine

__all__ = ["EngineConfig", "QueryEngine"]
