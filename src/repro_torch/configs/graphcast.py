"""graphcast [gnn]: 16-layer encoder-processor-decoder mesh GNN,
d_hidden=512, mesh_refinement=6, sum aggregation, n_vars=227.
[arXiv:2212.12794; unverified]

Port of ``repro/configs/graphcast.py``, the same field values.
Shape-cell mapping (DESIGN.md): the shape's graph is the MESH; grid
nodes = n_nodes (same count), g2m/m2g edges = 2 per grid node. Input
feature dim follows the shape's d_feat; output is n_vars channels.
"""
from repro_torch.configs import base
from repro_torch.models.gnn import GNNConfig


def full() -> GNNConfig:
    return GNNConfig(name="graphcast", kind="graphcast", n_layers=16,
                     d_hidden=512, d_in=227, n_classes=0, d_out=227,
                     n_vars=227, mesh_refinement=6,
                     aggregators=("sum",))


def smoke() -> GNNConfig:
    return GNNConfig(name="graphcast-smoke", kind="graphcast",
                     n_layers=2, d_hidden=16, d_in=12, n_classes=0,
                     d_out=5, n_vars=5, mesh_refinement=2,
                     aggregators=("sum",))


base.register(base.ArchSpec(
    arch_id="graphcast", family="gnn", full=full, smoke=smoke,
    shapes=base.GNN_SHAPES, notes="EPD mesh GNN; regression on n_vars"))
