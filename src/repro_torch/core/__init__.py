"""SLING core, ported to PyTorch: plan, Alg-4 walks, Alg-2 HP build,
index, single-source and top-k queries."""
from repro_torch.core.build import build_index, update_index
from repro_torch.core.index import SlingIndex
from repro_torch.core.theory import plan

__all__ = ["build_index", "update_index", "SlingIndex", "plan"]
