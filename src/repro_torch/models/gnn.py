"""GNN family: GCN, GAT, PNA, and a GraphCast-style
encoder-processor-decoder mesh GNN (port of ``repro/models/gnn.py``).

Message passing is an edge-index gather and a segment reduction
(``layers.segment_sum`` / ``segment_max``: ``index_add`` and
``scatter_reduce`` over the edges' destinations). The reference does
the same with XLA scatters outside any Pallas kernel (its docstring
names the ``spmv_ell`` kernel, which nothing there calls), so these are
plain torch ops on the card too. Every gather over the edges is
``index_select``, whose backward is ``index_add_`` (atomic adds on the
card): the backward of ``x[idx]`` sorts the ids and adds each run of
equal ones serially, and a padded batch aims all its pad edges at
node 0.

All models take a batch of static shapes:
  feats (N, F), edge_src (M,), edge_dst (M,), edge_mask (M,),
  node_mask (N,), labels (N,) or targets (N, out_dim)
Padded edges carry src = dst = 0 with edge_mask = 0. Arrays may be
NumPy or tensors; they are moved to the parameters' device.

Parameters live in a :class:`GNNParams` module under the reference's
names (``gnn.w.0``, ``gnn.a_src.0``, ``gnn.w_pre.1``, ``gnn.enc_grid``,
...; ``optim.adamw.named_leaves`` gives "gnn/w/0"), drawn from a
``torch.Generator`` in the reference's order, without
``requires_grad``: the training entry points turn it on for the model
they train. The reference's ``logical(...)`` sharding hints are left
out: the port's sharding is single-controller and
``launch.sharding.logical`` changes no value; the node-sharded GCN is
``models/gnn_sharded.py``.

One departure: PNA's std aggregator is ``sqrt(max(var, 0))``, whose
gradient the reference takes at var <= 0 as well, where sqrt's slope is
infinite and the product is NaN (a node whose incoming messages are
equal in a channel, as any in-degree-1 node's are). The port gives
those entries a zero gradient, with the same forward bits, so that PNA
trains; everywhere else the gradients are the reference's.

SLING integration (DESIGN.md section 5): ``sim_feat`` -- an optional
(N, k_sim) block of SimRank scores against k_sim anchor nodes, made by
the bulk join -- is concatenated to the input features when
cfg.sim_feats > 0.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.layers import (dense_init, leaky_relu, segment_max,
                                       segment_softmax, segment_sum)


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str                  # gcn | gat | pna | graphcast
    n_layers: int
    d_hidden: int
    d_in: int
    n_classes: int = 0         # 0 -> regression with out_dim = d_out
    d_out: int = 0
    n_heads: int = 1           # gat
    aggregators: tuple = ("mean",)
    scalers: tuple = ("identity",)
    mesh_refinement: int = 0   # graphcast
    n_vars: int = 0            # graphcast
    sim_feats: int = 0         # SLING feature block width
    dtype: Any = torch.float32

    @property
    def d_input_total(self) -> int:
        return self.d_in + self.sim_feats

    @property
    def out_dim(self) -> int:
        return self.n_classes if self.n_classes > 0 else self.d_out


# ----------------------------------------------------------------------
# params
# ----------------------------------------------------------------------
def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _plist(ts) -> nn.ParameterList:
    return nn.ParameterList([_param(t) for t in ts])


class GNNParams(nn.Module):
    """The parameters of ``init_params`` under ``self.gnn``, drawn in
    the reference's order from ``generator`` (a new one seeded with 0
    on ``device`` when None; ``device`` is ``cuda`` unless the caller
    passes ``device="cpu"``)."""

    def __init__(self, cfg: GNNConfig,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if generator is None:
            generator = torch.Generator(
                device=resolve_device(device)).manual_seed(0)
        gen = generator

        def w(*shape):
            return dense_init(gen, shape)

        d_in, dh = cfg.d_input_total, cfg.d_hidden
        g = nn.Module()
        if cfg.kind == "gcn":
            dims = [d_in] + [dh] * (cfg.n_layers - 1) + [cfg.out_dim]
            g.w = _plist(w(dims[i], dims[i + 1])
                         for i in range(cfg.n_layers))
            g.b = _plist(torch.zeros(dims[i + 1], device=gen.device)
                         for i in range(cfg.n_layers))
        elif cfg.kind == "gat":
            H = cfg.n_heads
            ws, a_src, a_dst = [w(d_in, H * dh)], [w(H, dh)], [w(H, dh)]
            for _ in range(cfg.n_layers - 2):
                ws.append(w(H * dh, H * dh))
                a_src.append(w(H, dh))
                a_dst.append(w(H, dh))
            # output layer: single head to out_dim
            ws.append(w(H * dh, cfg.out_dim))
            a_src.append(w(1, cfg.out_dim))
            a_dst.append(w(1, cfg.out_dim))
            g.w, g.a_src, g.a_dst = _plist(ws), _plist(a_src), _plist(a_dst)
        elif cfg.kind == "pna":
            n_agg = len(cfg.aggregators) * len(cfg.scalers)
            dims = [d_in] + [dh] * cfg.n_layers
            g.w_pre = _plist(w(dims[i], dh) for i in range(cfg.n_layers))
            g.w_post = _plist(w(dh * n_agg + dims[i], dims[i + 1])
                              for i in range(cfg.n_layers))
            g.w_out = _param(w(dh, cfg.out_dim))
        elif cfg.kind == "graphcast":
            g.enc_grid = _param(w(d_in, dh))
            g.enc_mesh = _param(w(d_in, dh))
            g.g2m_edge = _param(w(2 * dh, dh))
            g.proc_edge = _plist(w(2 * dh, dh) for _ in range(cfg.n_layers))
            g.proc_node = _plist(w(2 * dh, dh) for _ in range(cfg.n_layers))
            g.m2g_edge = _param(w(2 * dh, dh))
            g.dec = _param(w(dh, cfg.n_vars))
        else:
            raise ValueError(cfg.kind)
        self.gnn = g

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


def init_params(cfg: GNNConfig, generator: torch.Generator | None = None,
                *, device=None) -> GNNParams:
    """The reference's ``init_params``: a :class:`GNNParams` drawn from
    ``generator`` (seeded 0 on ``device`` when None; ``device`` is
    ``cuda`` unless the caller passes ``device="cpu"``)."""
    return GNNParams(cfg, generator=generator, device=device)


# ----------------------------------------------------------------------
# message-passing primitives
# ----------------------------------------------------------------------
def gcn_norm_weights(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                     edge_mask: torch.Tensor, n: int):
    """Symmetric normalization: edge weight 1/sqrt(d~_src d~_dst) and
    self-loop weight 1/d~_v, with d~ = deg + 1 (Kipf & Welling)."""
    ones = edge_mask.to(torch.float32)
    deg = segment_sum(ones, edge_dst, n) + 1.0
    deg_s = segment_sum(ones, edge_src, n) + 1.0
    w_edge = (ones * torch.rsqrt(deg_s.index_select(0, edge_src.long()))
              * torch.rsqrt(deg.index_select(0, edge_dst.long())))
    w_self = 1.0 / deg
    return w_edge, w_self


def spmm(h: torch.Tensor, edge_src: torch.Tensor, edge_dst: torch.Tensor,
         w_edge: torch.Tensor, n: int) -> torch.Tensor:
    """segment-sum SpMM: out[v] = sum_{e: dst=v} w_e * h[src_e]."""
    return segment_sum(h.index_select(0, edge_src.long()) * w_edge[:, None],
                       edge_dst, n)


def _pna_std(var: torch.Tensor) -> torch.Tensor:
    """``sqrt(max(var, 0))`` with a zero gradient where var <= 0 (the
    reference's is NaN there; see the module docstring)."""
    pos = var > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, var, 1.0)), 0.0)


# ----------------------------------------------------------------------
# forward passes
# ----------------------------------------------------------------------
def _on(batch: dict, dev: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def forward(cfg: GNNConfig, params: GNNParams, batch: dict) -> torch.Tensor:
    b = _on(batch, params.device)
    feats = b["feats"]
    if cfg.sim_feats > 0:
        feats = torch.cat([feats, b["sim_feat"]], dim=-1)
    es, ed = b["edge_src"].long(), b["edge_dst"].long()
    em = b["edge_mask"]
    n = feats.shape[0]
    g = params.gnn

    if cfg.kind == "gcn":
        w_e, w_self = gcn_norm_weights(es, ed, em, n)
        h = feats
        for i in range(cfg.n_layers):
            h = h @ g.w[i] + g.b[i]
            h = spmm(h, es, ed, w_e, n) + h * w_self[:, None]
            if i < cfg.n_layers - 1:
                h = torch.relu(h)
        return h

    if cfg.kind == "gat":
        h = feats
        L = cfg.n_layers
        live = em[:, None] > 0
        for i in range(L):
            H = cfg.n_heads if i < L - 1 else 1
            dh = cfg.d_hidden if i < L - 1 else cfg.out_dim
            z = (h @ g.w[i]).reshape(n, H, dh)
            sc_src = (z * g.a_src[i][None]).sum(-1)      # (N, H)
            sc_dst = (z * g.a_dst[i][None]).sum(-1)
            e = leaky_relu(sc_src.index_select(0, es)
                           + sc_dst.index_select(0, ed))  # (M, H)
            e = torch.where(live, e, -1e30)
            # every head at once: one (M, H) softmax over the edges
            alpha = segment_softmax(e, ed, n) * em[:, None]
            msgs = z.index_select(0, es) * alpha[:, :, None]  # (M, H, dh)
            h = segment_sum(msgs, ed, n).reshape(n, H * dh)
            if i < L - 1:
                h = torch.nn.functional.elu(h)
        return h

    if cfg.kind == "pna":
        ones = em.to(torch.float32)
        deg = segment_sum(ones, ed, n)
        log_deg = torch.log1p(deg)[:, None]
        mean_log_deg = torch.mean(log_deg) + 1e-6
        deg1 = torch.clamp(deg, min=1.0)[:, None]
        live = em[:, None] > 0
        h = feats
        for i in range(cfg.n_layers):
            z = torch.relu(h @ g.w_pre[i])               # (N, dh)
            zs = z.index_select(0, es)
            msgs = zs * em[:, None]
            s_sum = segment_sum(msgs, ed, n)
            s_mean = s_sum / deg1
            s_max = segment_max(torch.where(live, zs, -1e30), ed, n)
            s_max = torch.where(torch.isfinite(s_max), s_max, 0.0)
            s_min = -segment_max(-torch.where(live, zs, 1e30), ed, n)
            s_min = torch.where(torch.isfinite(s_min), s_min, 0.0)
            sq = segment_sum(msgs * msgs, ed, n)
            s_std = _pna_std(sq / deg1 - s_mean ** 2)
            aggs = {"mean": s_mean, "max": s_max, "min": s_min,
                    "std": s_std, "sum": s_sum}
            cols = []
            for a in cfg.aggregators:
                base = aggs[a]
                for s in cfg.scalers:
                    if s == "identity":
                        cols.append(base)
                    elif s == "amplification":
                        cols.append(base * (log_deg / mean_log_deg))
                    elif s == "attenuation":
                        cols.append(base * (mean_log_deg
                                            / torch.clamp(log_deg,
                                                          min=1e-6)))
            h = torch.relu(torch.cat(cols + [h], dim=-1) @ g.w_post[i])
        return h @ g.w_out

    if cfg.kind == "graphcast":
        # grid nodes [0, n_grid), mesh nodes [n_grid, n): the encoder
        # moves grid state onto the mesh, n_layers of mesh message
        # passing, the decoder returns to the grid and predicts n_vars
        grid = torch.arange(n, device=feats.device) < b["n_grid"]
        h = torch.where(grid[:, None], torch.relu(feats @ g.enc_grid),
                        torch.relu(feats @ g.enc_mesh))

        def exchange(h, src, dst, mask, w):
            src, dst = src.long(), dst.long()
            msg = torch.relu(torch.cat([h.index_select(0, src),
                                        h.index_select(0, dst)], -1) @ w)
            return segment_sum(msg * mask[:, None], dst, n)

        h = h + exchange(h, b["g2m_src"], b["g2m_dst"], b["g2m_mask"],
                         g.g2m_edge)
        for i in range(cfg.n_layers):
            agg = exchange(h, es, ed, em, g.proc_edge[i])
            h = h + torch.relu(torch.cat([h, agg], -1) @ g.proc_node[i])
        h = h + exchange(h, b["m2g_src"], b["m2g_dst"], b["m2g_mask"],
                         g.m2g_edge)
        return h @ g.dec

    raise ValueError(cfg.kind)


def loss_fn(cfg: GNNConfig, params: GNNParams, batch: dict) -> torch.Tensor:
    """Masked mean cross-entropy over the nodes (``n_classes > 0``) or
    masked mean squared error against ``targets``, in float32."""
    out = forward(cfg, params, batch)
    b = _on({k: batch[k] for k in ("node_mask", "labels", "targets")
             if k in batch}, out.device)
    mask = b["node_mask"].to(torch.float32)
    if cfg.n_classes > 0:
        logits = out.to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, b["labels"].long()[:, None])[:, 0]
        nll = (logz - gold) * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    err = (out - b["targets"]) ** 2
    return (err.mean(-1) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
