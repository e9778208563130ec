"""Step factories (port of ``repro/train/steps.py``: the LM, GNN,
recsys and SLING steps).

``lm_train_step``, ``gnn_train_step`` and ``recsys_train_step`` return
``step(params, opt_state, batch) -> (params, opt_state, {"loss"})``:
one AdamW step in place (for xDeepFM the CIN's gradient through its
kernels on the card). The serving and inference steps return
``step(params, batch)``, the LM decode step ``step(params, cache,
batch)``, the SLING steps ``step(index, graph, batch)``; each runs
under ``torch.inference_mode``, the LM's prefill and decode under
``torch.no_grad`` (a decode step writes into the cache it is given,
which may have been made outside inference mode). The port runs
eagerly: nothing is traced or compiled.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.topk import stable_topk
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import recsys as recsys_lib
from repro_torch.models import transformer as tf_lib

RETRIEVAL_K = 128


def lm_train_step(cfg, opt) -> Callable:
    """One training step of the LM ``params`` (an ``LMParams``, trained
    in place) on ``batch`` (tokens, targets: (B, S) ids) with the AdamW
    ``opt``: the chunked loss, its gradient on every leaf, the update."""
    from repro_torch.train.trainer import value_and_grad

    def step(params, opt_state, batch):
        loss, grads = value_and_grad(
            lambda p, b: tf_lib.lm_loss(cfg, p, b["tokens"], b["targets"]),
            params, batch)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss}
    return step


def lm_prefill_step(cfg) -> Callable:
    """{"logits": last-token logits (B, V) float32, "cache": a cache of
    exactly S slots} of ``batch["tokens"]`` (B, S)."""
    def step(params, batch):
        logits, cache = tf_lib.prefill(cfg, params, batch["tokens"])
        return {"logits": logits, "cache": cache}
    return step


def lm_decode_step(cfg) -> Callable:
    """{"logits" (B, V) float32, "cache"} after one token
    ``batch["token"]`` (B,); ``cache``'s tensors are written in place."""
    def step(params, cache, batch):
        logits, cache = tf_lib.decode_step(cfg, params, cache,
                                           batch["token"])
        return {"logits": logits, "cache": cache}
    return step


def gnn_train_step(cfg, opt) -> Callable:
    """One training step of the GNN ``params`` (a ``GNNParams``, trained
    in place) on a full or sampled graph ``batch`` with the AdamW
    ``opt``: the loss, its gradient on every leaf, the update."""
    from repro_torch.train.trainer import value_and_grad

    def step(params, opt_state, batch):
        loss, grads = value_and_grad(
            lambda p, b: gnn_lib.loss_fn(cfg, p, b), params, batch)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss}
    return step


def gnn_infer_step(cfg) -> Callable:
    """The model's outputs on every node of ``batch``: (N, out_dim)."""
    def step(params, batch):
        with torch.inference_mode():
            return gnn_lib.forward(cfg, params, batch)
    return step


def recsys_train_step(cfg, opt) -> Callable:
    """One training step of the xDeepFM ``params`` (an ``XDeepFM``,
    trained in place) on ``batch`` (ids, labels[, mh_ids]) with the
    AdamW ``opt``: the loss, its gradient on every leaf, the update."""
    from repro_torch.train.trainer import value_and_grad

    def step(params, opt_state, batch):
        loss, grads = value_and_grad(
            lambda p, b: recsys_lib.loss_fn(cfg, p, b), params, batch)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss}
    return step


def recsys_serve_step(cfg) -> Callable:
    """Click probabilities (B,): the sigmoid of ``forward``."""
    def step(params, batch):
        with torch.inference_mode():
            return torch.sigmoid(recsys_lib.forward(cfg, params, batch))
    return step


def recsys_retrieval_step(cfg) -> Callable:
    """Scores of every candidate and the top 128: {"scores" (C,),
    "top_v" (128,), "top_i" (128,) int32}, descending, equal scores in
    ascending candidate order (as ``jax.lax.top_k``)."""
    def step(params, batch):
        with torch.inference_mode():
            scores = recsys_lib.score_candidates(cfg, params, batch)
            top_v, top_i = stable_topk(scores[None], RETRIEVAL_K)
            return {"scores": scores, "top_v": top_v[0], "top_i": top_i[0]}
    return step


def _sling_tau(cfg) -> float:
    """Resolved Horner prune threshold (single_source.prune_tau) at the
    paper's operating point theta = 0.000725; the configs carry (c,
    l_max) but no theory.SlingPlan."""
    return 0.000725 * (cfg.c ** 0.5) ** cfg.l_max


def sling_serve_step(cfg) -> Callable:
    """Batched single-source SimRank (Alg 6, Horner) as a serving cell:
    ``index`` {"keys" (N, W) int32, "vals" (N, W) float32, "d" (n,)
    float32}, ``graph`` {"layout": Â's ``SpmmLayout``} (the reference
    passes the edge list, edge_src / edge_dst / w, which the layout
    holds grouped by destination), ``batch`` {"us" (B,) ids} -> (B,
    cfg.n) float32 scores on the index's device: one launch of the
    Horner push kernel on ``cuda``."""
    from repro_torch.core.single_source import batched_single_source

    tau = _sling_tau(cfg)

    def step(index, graph, batch):
        with torch.inference_mode():
            return batched_single_source(
                index["keys"], index["vals"], index["d"], graph["layout"],
                torch.as_tensor(batch["us"], device=index["keys"].device),
                tau, n=cfg.n, l_max=cfg.l_max)
    return step


def sling_serve_step_sharded(cfg, mesh,
                             bf16_frontier: bool = False) -> Callable:
    """Pod-scale variant (``single_source.batched_single_source_sharded``):
    queries over the mesh's data axes, nodes over "model". ``graph``
    holds the reference's destination-partitioned edges ("blk_src",
    "blk_dstl", "blk_w", each (S_model, E); ``shard_query.
    partition_edges``) and optionally "slabs", the
    ``single_source.pod_slabs`` of them built once, which the push then
    reads instead. Returns (B, cfg.n) float32 on the mesh's first
    device. The query ids are read on the host; fake ids (the dry run's)
    stay where they are, and the read is declared
    (``kernels/cost.host_read``)."""
    from repro_torch.core.single_source import batched_single_source_sharded
    from repro_torch.kernels.cost import host_read, is_fake

    tau = _sling_tau(cfg)

    def step(index, graph, batch):
        us = batch["us"]
        if is_fake(us):
            host_read("_to_copy")
        else:
            us = torch.as_tensor(us).cpu()
        with torch.inference_mode():
            return batched_single_source_sharded(
                index["keys"], index["vals"], index["d"],
                graph.get("blk_src"), graph.get("blk_dstl"),
                graph.get("blk_w"), us, tau, cfg.n, cfg.l_max,
                mesh, bf16_frontier=bf16_frontier,
                slabs=graph.get("slabs"))
    return step
