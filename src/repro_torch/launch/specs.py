"""Shape cells and analytic FLOP counts (port of the recsys part of
``repro/launch/specs.py``; the dry run comes later)."""
from __future__ import annotations

RECSYS_SHAPE_DEFS = {
    "train_batch":    dict(kind="train", batch=65536),
    "serve_p99":      dict(kind="serve", batch=512),
    "serve_bulk":     dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", n_candidates=1_000_000),
}


def recsys_model_flops(cfg, batch: int, train: bool) -> float:
    """Useful FLOPs of one step: CIN plus MLP (x3 for training)."""
    F, D = cfg.n_fields, cfg.embed_dim
    cin = 0.0
    h_prev = F
    for h in cfg.cin_layers:
        cin += 2.0 * batch * h * h_prev * F * D
        h_prev = h
    mlp = 0.0
    prev = F * D
    for m_ in cfg.mlp_layers:
        mlp += 2.0 * batch * prev * m_
        prev = m_
    fwd = cin + mlp
    return 3.0 * fwd if train else fwd
