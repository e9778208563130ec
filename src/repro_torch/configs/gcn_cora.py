"""gcn-cora [gnn]: 2 layers, d_hidden=16, mean/sym-norm aggregation.
[arXiv:1609.02907; paper]

Port of ``repro/configs/gcn_cora.py``, the same field values.
"""
from repro_torch.configs import base
from repro_torch.models.gnn import GNNConfig


def full() -> GNNConfig:
    return GNNConfig(name="gcn-cora", kind="gcn", n_layers=2,
                     d_hidden=16, d_in=1433, n_classes=7)


def smoke() -> GNNConfig:
    return GNNConfig(name="gcn-smoke", kind="gcn", n_layers=2,
                     d_hidden=8, d_in=12, n_classes=4)


base.register(base.ArchSpec(
    arch_id="gcn-cora", family="gnn", full=full, smoke=smoke,
    shapes=base.GNN_SHAPES,
    notes="d_in follows the shape cell's d_feat at lowering time"))
