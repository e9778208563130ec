"""xDeepFM (Lian et al., KDD'18): linear + CIN + deep MLP over sparse
field embeddings, for serving and training (port of
``repro/models/recsys.py``).

Assigned config: 39 sparse fields, embed_dim 10, CIN layers 200-200-200,
MLP 400-400. Every CIN layer
    x^k_{h,d} = sum_{i,j} W^k_{h,i,j} * x^{k-1}_{i,d} * x^0_{j,d}
goes through ``kernels/cin`` by device: the Hopper kernel for CUDA
tensors, the plain version for CPU tensors; under autograd the layer's
gradient runs the ``cin`` backward kernels on the card. The MLP's
matrix products and the embedding gathers are torch ops.

Parameters live in an :class:`XDeepFM` module under the reference's
names (``tables.embed``, ``tables.linear``, ``recsys.cin_w.<k>``,
``recsys.mlp_w.<k>``, ``recsys.mlp_b.<k>``, ``recsys.mlp_out``,
``recsys.cin_out``, ``recsys.bias``, ``recsys.sim_w``), drawn from a
``torch.Generator`` (``init_params``). They are made without
``requires_grad``, so serving records no graph; the training entry
points (``train.trainer``, ``train.steps.recsys_train_step``) turn it
on for the model they train. ``loss_fn`` is the reference's stable
BCE-with-logits in float32.

SLING integration (DESIGN.md section 5): with ``sim_prior``,
``score_candidates`` adds ``sim_w`` times a SimRank single-source prior
over the user-item click graph to the retrieval logits.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels.cin import ops as cin_ops
from repro_torch.models import embeddings
from repro_torch.models.layers import dense_init


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    n_fields: int = 39
    vocab_per_field: int = 1_000_000
    embed_dim: int = 10
    cin_layers: tuple = (200, 200, 200)
    mlp_layers: tuple = (400, 400)
    n_user_fields: int = 20     # retrieval: fields fixed per query user
    multi_hot_fields: int = 2   # trailing fields use EmbeddingBag
    bag_size: int = 8
    sim_prior: bool = False     # fuse SLING SimRank retrieval prior
    dtype: Any = torch.float32

    def param_count(self) -> int:
        e = self.n_fields * self.vocab_per_field * self.embed_dim
        lin = self.n_fields * self.vocab_per_field
        cin = 0
        h_prev = self.n_fields
        for h in self.cin_layers:
            cin += h * h_prev * self.n_fields
            h_prev = h
        d0 = self.n_fields * self.embed_dim
        mlp = 0
        prev = d0
        for m in self.mlp_layers:
            mlp += prev * m + m
            prev = m
        return e + lin + cin + mlp + prev + sum(self.cin_layers)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class XDeepFM(nn.Module):
    """The parameters of ``init_params``, drawn in the reference's order
    from ``generator`` (a new one seeded with 0 on ``device`` when None;
    ``device`` is ``cuda`` unless the caller passes ``device="cpu"``)."""

    def __init__(self, cfg: RecsysConfig,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if generator is None:
            dev = resolve_device(device)
            generator = torch.Generator(device=dev).manual_seed(0)
        gen = generator
        dev = gen.device
        F, V, D = cfg.n_fields, cfg.vocab_per_field, cfg.embed_dim
        dt = cfg.dtype
        self.cfg = cfg
        self.tables = nn.ParameterDict({
            "embed": _param(dense_init(gen, (F, V, D), 0.01, dt)),
            "linear": _param(dense_init(gen, (F, V, 1), 0.01, dt)),
        })
        r = nn.Module()
        cin_w, h_prev = [], F
        for h in cfg.cin_layers:
            cin_w.append(_param(dense_init(gen, (h, h_prev, F), dtype=dt)))
            h_prev = h
        r.cin_w = nn.ParameterList(cin_w)
        mlp_w, mlp_b, prev = [], [], F * D
        for m in cfg.mlp_layers:
            mlp_w.append(_param(dense_init(gen, (prev, m), dtype=dt)))
            mlp_b.append(_param(torch.zeros(m, dtype=dt, device=dev)))
            prev = m
        r.mlp_w = nn.ParameterList(mlp_w)
        r.mlp_b = nn.ParameterList(mlp_b)
        r.mlp_out = _param(dense_init(gen, (prev, 1), dtype=dt))
        r.cin_out = _param(dense_init(gen, (sum(cfg.cin_layers), 1),
                                      dtype=dt))
        r.bias = _param(torch.zeros((), dtype=dt, device=dev))
        if cfg.sim_prior:
            r.sim_w = _param(torch.ones((), dtype=dt, device=dev) * 0.1)
        self.recsys = r

    @property
    def device(self) -> torch.device:
        return self.tables["embed"].device


def init_params(cfg: RecsysConfig, generator: torch.Generator | None = None,
                device=None) -> XDeepFM:
    """The reference's ``init_params``: an :class:`XDeepFM` drawn from
    ``generator`` (seeded 0 on ``device`` when None; ``device`` is
    ``cuda`` unless the caller passes ``device="cpu"``)."""
    return XDeepFM(cfg, generator=generator, device=device)


def cin(x0: torch.Tensor, weights, use_kernel: bool = True, *,
        backend: str | None = None) -> torch.Tensor:
    """Compressed Interaction Network: x0 (B, F, D); weights: list of
    (H_k, H_{k-1}, F). Returns (B, sum_k H_k) sum-pooled features.

    ``use_kernel`` is the reference's third positional: True (the
    port's default, where the reference's is False) takes every layer
    through ``kernels/cin`` -- the Hopper kernel for CUDA tensors, the
    plain version for CPU ones -- and False the plain layer on any
    device. ``backend`` names the same choice by the layer wrapper's
    words ("auto" or "plain") and wins over the default; with
    ``use_kernel=False`` only "plain" is accepted."""
    if backend is None:
        backend = "auto" if use_kernel else "plain"
    elif not use_kernel and backend != "plain":
        raise ValueError(f"cin: use_kernel=False with backend {backend!r}")
    return cin_ops.cin_forward(x0, list(weights), backend=backend)


def embed(cfg: RecsysConfig, params: XDeepFM, batch: dict) -> torch.Tensor:
    """The field embeddings x0 (B, F, D) of a batch: one row per field,
    the multi-hot fields' rows replaced by their bags' means."""
    dev = params.device
    ids = torch.as_tensor(batch["ids"], device=dev).long()
    B, F = ids.shape
    table = params.tables["embed"]
    emb = embeddings.field_lookup_all(table, ids)
    if cfg.multi_hot_fields > 0 and "mh_ids" in batch:
        # trailing fields are multi-hot: EmbeddingBag overrides the
        # single-id lookup for those field slots
        mh = torch.as_tensor(batch["mh_ids"], device=dev).long()
        n_mh = mh.shape[1]
        f0 = F - n_mh
        V, D = cfg.vocab_per_field, cfg.embed_dim
        flat_table = table[f0:].reshape(n_mh * V, D)     # a view
        rows = (mh + torch.arange(n_mh, device=dev)[None, :, None] * V
                ).reshape(-1)
        bag = torch.arange(B * n_mh, device=dev).repeat_interleave(
            cfg.bag_size)
        bagged = embeddings.embedding_bag(flat_table, rows, bag, B * n_mh,
                                          mode="mean")
        emb[:, f0:, :] = bagged.reshape(B, n_mh, D)
    return emb


def forward(cfg: RecsysConfig, params: XDeepFM, batch: dict,
            backend: str = "auto") -> torch.Tensor:
    """batch: ids (B, F) [+ optional mh_ids (B, n_mh, bag) for the
    multi-hot fields, + sim_scores (B,) with ``cfg.sim_prior``] ->
    logits (B,). Arrays may be NumPy or tensors of any integer type."""
    dev = params.device
    ids = torch.as_tensor(batch["ids"], device=dev).long()
    B, F = ids.shape
    emb = embed(cfg, params, {**batch, "ids": ids})

    lin = embeddings.field_lookup_all(params.tables["linear"], ids)
    lin_logit = lin.sum(dim=(1, 2))                 # (B,)

    r = params.recsys
    cin_feat = cin(emb, r.cin_w, backend=backend)
    cin_logit = (cin_feat @ r.cin_out)[:, 0]

    h = emb.reshape(B, F * cfg.embed_dim)
    for w, b in zip(r.mlp_w, r.mlp_b):
        h = torch.relu(h @ w + b)
    mlp_logit = (h @ r.mlp_out)[:, 0]

    logit = lin_logit + cin_logit + mlp_logit + r.bias
    if cfg.sim_prior and "sim_scores" in batch:
        logit = logit + r.sim_w * torch.as_tensor(batch["sim_scores"],
                                                  device=dev)
    return logit


def loss_fn(cfg: RecsysConfig, params: XDeepFM, batch: dict) -> torch.Tensor:
    """Mean binary cross-entropy of the logits against ``batch["labels"]``
    (B,), in float32, in the reference's stable form max(l, 0) - l*y +
    log1p(exp(-|l|))."""
    logit = forward(cfg, params, batch).to(torch.float32)
    y = torch.as_tensor(batch["labels"], device=logit.device).to(
        torch.float32)
    return torch.mean(torch.clamp(logit, min=0) - logit * y
                      + torch.log1p(torch.exp(-torch.abs(logit))))


def score_candidates(cfg: RecsysConfig, params: XDeepFM, batch: dict,
                     backend: str = "auto") -> torch.Tensor:
    """Retrieval cell: one user (n_user_fields ids) x C candidates
    (remaining fields per candidate). Returns (C,) scores; the SimRank
    prior (``sim_scores``, (C,)) is added here once, after a forward
    pass that does not see it."""
    dev = params.device
    user_ids = torch.as_tensor(batch["user_ids"], device=dev).long()
    cand_ids = torch.as_tensor(batch["cand_ids"], device=dev).long()
    C = cand_ids.shape[0]
    full = torch.cat([user_ids[None].expand(C, -1), cand_ids], dim=1)
    scores = forward(cfg, params, {"ids": full}, backend=backend)
    if cfg.sim_prior and "sim_scores" in batch:
        scores = scores + params.recsys.sim_w * torch.as_tensor(
            batch["sim_scores"], device=dev)
    return scores
