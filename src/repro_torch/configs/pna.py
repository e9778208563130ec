"""pna [gnn]: 4 layers, d_hidden=75, aggregators mean/max/min/std,
scalers identity/amplification/attenuation. [arXiv:2004.05718; paper]

Port of ``repro/configs/pna.py``, the same field values.
"""
from repro_torch.configs import base
from repro_torch.models.gnn import GNNConfig

AGGS = ("mean", "max", "min", "std")
SCALERS = ("identity", "amplification", "attenuation")


def full() -> GNNConfig:
    return GNNConfig(name="pna", kind="pna", n_layers=4, d_hidden=75,
                     d_in=1433, n_classes=10,
                     aggregators=AGGS, scalers=SCALERS)


def smoke() -> GNNConfig:
    return GNNConfig(name="pna-smoke", kind="pna", n_layers=2,
                     d_hidden=8, d_in=12, n_classes=4,
                     aggregators=AGGS, scalers=SCALERS)


base.register(base.ArchSpec(
    arch_id="pna", family="gnn", full=full, smoke=smoke,
    shapes=base.GNN_SHAPES, notes="12 aggregator x scaler channels"))
