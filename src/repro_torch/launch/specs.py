"""Shape cells and analytic FLOP counts (port of the LM, GNN and recsys
parts of ``repro/launch/specs.py``). The reference's ``Cell`` /
``make_cell`` and the per-family cells that wrap the train steps, the
dry run and the HLO tools are not ported yet (ROADMAP.md, queue 1,
item 4); the sharded GCN's step is composed from ``gcn_loss_sharded``
and AdamW where it is used."""
from __future__ import annotations

LM_SHAPE_DEFS = {
    "train_4k":    dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k":  dict(kind="decode", seq=32768, batch=128),
    "long_500k":   dict(kind="decode", seq=524288, batch=1),
}

GNN_SHAPE_DEFS = {
    # minibatch_lg: sampled subgraph sizes from batch_nodes=1024 with
    # fanout 15-10 over the (232965, 114.6M) parent graph; d_feat=602
    # (Reddit). molecule: 128 graphs x (30 nodes, 64 edges) flattened.
    "full_graph_sm": dict(n=2708, m=10556, d_feat=1433),
    "minibatch_lg":  dict(n=169984, m=168960, d_feat=602),
    "ogb_products":  dict(n=2449029, m=61859140, d_feat=100),
    "molecule":      dict(n=3840, m=8192, d_feat=64),
}

RECSYS_SHAPE_DEFS = {
    "train_batch":    dict(kind="train", batch=65536),
    "serve_p99":      dict(kind="serve", batch=512),
    "serve_bulk":     dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", n_candidates=1_000_000),
}


def lm_model_flops(cfg, kind: str, batch: int, seq: int) -> float:
    """Useful FLOPs (no remat recompute): 6ND train / 2ND inference
    plus causal attention 2*B*S^2*H*dh per layer fwd (x3 for train),
    the reference's analytic count."""
    n_act = cfg.active_param_count()
    tokens = batch * seq
    attn_fwd = 2.0 * cfg.n_layers * cfg.n_heads * cfg.d_head * seq * tokens / 2
    if kind == "train":
        return 6.0 * n_act * tokens + 3.0 * attn_fwd
    if kind == "prefill":
        return 2.0 * n_act * tokens + attn_fwd
    # decode: one token vs full cache
    return (2.0 * n_act * batch
            + 4.0 * cfg.n_layers * cfg.n_heads * cfg.d_head * seq * batch)


def gnn_model_flops(cfg, n: int, m: int, d_feat: int) -> float:
    """Useful FLOPs of one training step (forward x3), the reference's
    analytic count."""
    dh = cfg.d_hidden
    per_layer = 2.0 * n * dh * dh + 2.0 * m * dh
    fwd = 2.0 * n * d_feat * dh + cfg.n_layers * per_layer
    if cfg.kind == "pna":
        fwd *= len(cfg.aggregators) * len(cfg.scalers) * 0.5 + 1
    if cfg.kind == "graphcast":
        fwd = 2.0 * n * d_feat * dh + cfg.n_layers * (
            2.0 * m * (2 * dh) * dh + 2.0 * n * (2 * dh) * dh)
    return 3.0 * fwd  # train = fwd + 2x bwd


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
