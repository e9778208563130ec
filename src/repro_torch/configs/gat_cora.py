"""gat-cora [gnn]: 2 layers, d_hidden=8, 8 heads, attention aggregation.
[arXiv:1710.10903; paper]

Port of ``repro/configs/gat_cora.py``, the same field values.
"""
from repro_torch.configs import base
from repro_torch.models.gnn import GNNConfig


def full() -> GNNConfig:
    return GNNConfig(name="gat-cora", kind="gat", n_layers=2,
                     d_hidden=8, n_heads=8, d_in=1433, n_classes=7)


def smoke() -> GNNConfig:
    return GNNConfig(name="gat-smoke", kind="gat", n_layers=2,
                     d_hidden=4, n_heads=2, d_in=12, n_classes=4)


base.register(base.ArchSpec(
    arch_id="gat-cora", family="gnn", full=full, smoke=smoke,
    shapes=base.GNN_SHAPES, notes="SDDMM edge-softmax SpMM regime"))
