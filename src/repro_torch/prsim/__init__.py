"""PRSim-style power-law index backend (DESIGN.md §15), ported from
``repro/prsim``.

Another *construction schedule* for the same certified SLING index: a
reverse-PageRank pass ranks the nodes, the hub set's HP columns are
propagated in small batches, and the long tail in large sparse blocks.
The triples equal the SLING sparse schedule's bit for bit and pack into
the unchanged v3 artifact; serving never knows which builder ran.
"""
from repro_torch.prsim.builder import (PrsimStats, build_prsim_coo,
                                       hub_set, prsim_hp_coo)
from repro_torch.prsim.pagerank import reverse_pagerank

__all__ = ["reverse_pagerank", "PrsimStats", "build_prsim_coo",
           "hub_set", "prsim_hp_coo"]
