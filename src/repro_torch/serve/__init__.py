"""Serving layer of the port: the single-device ``QueryEngine`` and the
async SLO-aware admission frontend over its replicas."""
from repro_torch.serve.clock import MonotonicClock, VirtualClock
from repro_torch.serve.engine import EngineConfig, QueryEngine
from repro_torch.serve.frontend import (FrontendConfig, ServeFrontend,
                                        ShedError, Ticket)
from repro_torch.serve.load import zipf_nodes, zipf_weights

__all__ = ["EngineConfig", "QueryEngine", "FrontendConfig",
           "ServeFrontend", "ShedError", "Ticket", "MonotonicClock",
           "VirtualClock", "zipf_nodes", "zipf_weights"]
