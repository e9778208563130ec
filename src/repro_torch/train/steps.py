"""Step factories (port of the serving half of ``repro/train/steps.py``).

Each returns ``step(params, batch)``, run under ``torch.inference_mode``
(the port runs eagerly: nothing is traced or compiled). Training steps
come with the training slice.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.topk import stable_topk
from repro_torch.models import recsys as recsys_lib

RETRIEVAL_K = 128


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
