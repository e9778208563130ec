"""xdeepfm [recsys]: 39 sparse fields, embed_dim=10, CIN 200-200-200,
MLP 400-400, CIN interaction. [arXiv:1803.05170; paper]

Port of ``repro/configs/xdeepfm.py``, the same field values. 1e6 rows
per field: 432,742,000 parameters, 1.73 GB in float32, which one H100
holds whole. retrieval_cand scores 1 user against 1e6 candidates,
optionally with a SLING SimRank prior over the user-item click graph
(DESIGN.md section 5).
"""
from repro_torch.configs import base
from repro_torch.models.recsys import RecsysConfig


def full() -> RecsysConfig:
    return RecsysConfig(name="xdeepfm", n_fields=39,
                        vocab_per_field=1_000_000, embed_dim=10,
                        cin_layers=(200, 200, 200), mlp_layers=(400, 400),
                        n_user_fields=20, multi_hot_fields=2, bag_size=8)


def smoke() -> RecsysConfig:
    return RecsysConfig(name="xdeepfm-smoke", n_fields=8,
                        vocab_per_field=64, embed_dim=4,
                        cin_layers=(6, 6), mlp_layers=(16, 16),
                        n_user_fields=4, multi_hot_fields=2, bag_size=3)


base.register(base.ArchSpec(
    arch_id="xdeepfm", family="recsys", full=full, smoke=smoke,
    shapes=base.RECSYS_SHAPES, notes="embedding lookup is the hot path"))
