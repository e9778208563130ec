"""Config registry: every architecture the port has registers an
ArchSpec (port of ``repro/configs/base.py``).

Each arch module defines ``full()`` (the exact assigned config),
``smoke()`` (a reduced config of the same family for CPU tests) and the
shape cells it takes part in. The port holds every family of the
reference: the LM family (smollm-135m, gemma3-1b, qwen3-14b,
mixtral-8x22b, llama4-scout-17b-a16e), the GNN family (gcn-cora,
gat-cora, pna, graphcast), xDeepFM and the paper's own ``sling-serve``
cell.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
RECSYS_SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str
    full: Callable[[], Any]
    smoke: Callable[[], Any]
    shapes: tuple
    notes: str = ""


_REGISTRY: dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.arch_id] = spec
    return spec


def get(arch_id: str) -> ArchSpec:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def all_archs() -> dict[str, ArchSpec]:
    _ensure_loaded()
    return dict(_REGISTRY)


def _ensure_loaded() -> None:
    from repro_torch.configs import (gat_cora, gcn_cora,  # noqa: F401
                                     gemma3_1b, graphcast,
                                     llama4_scout_17b_a16e, mixtral_8x22b,
                                     pna, qwen3_14b, sling_paper,
                                     smollm_135m, xdeepfm)
