"""Carry graphs and built indexes across from plain arrays.

A graph or index built elsewhere (the JAX reference, a saved run) is
handed over as NumPy arrays and a plan dict, so both packages can
answer the same queries on the same state with no RNG in between:

    g2 = graph_from_arrays(g.n, g.edge_src, g.edge_dst)
    idx2 = index_from_arrays(dataclasses.asdict(idx.plan), idx.d,
                             idx.hp.keys, idx.vals_f32(), idx.hp.counts,
                             device="cpu")
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hp_index import HPTable
from repro_torch.core.index import SlingIndex
from repro_torch.core.theory import SlingPlan
from repro_torch.device import resolve_device
from repro_torch.graph import csr


def graph_from_arrays(n: int, src, dst) -> csr.Graph:
    """Graph from a directed edge list; parallel edges are kept, so a
    multigraph keeps its multiplicities."""
    return csr.from_edges(int(n), np.asarray(src), np.asarray(dst),
                          dedup=False)


def index_from_arrays(plan: dict, d, keys, vals, counts,
                      builder: str = "sling", uncertified_d: bool = False,
                      device=None) -> SlingIndex:
    """SlingIndex from a plan dict (``dataclasses.asdict`` of a plan),
    d (n,), packed keys/vals (n, width) and counts (n,), on ``device``
    (``cuda`` unless ``device="cpu"``). The tensors are copies, never
    views of the given arrays: ``update_index`` changes an index in
    place, and must not reach the arrays it was carried from."""
    dev = resolve_device(device)
    p = SlingPlan(**plan)
    keys = np.asarray(keys, np.int32)
    vals = np.asarray(vals, np.float32)
    if keys.ndim != 2 or vals.shape != keys.shape:
        raise ValueError("keys/vals must be one (n, width) shape")
    n, width = keys.shape
    hp = HPTable(n=n, width=width,
                 keys=torch.tensor(keys, device=dev),
                 vals=torch.tensor(vals, device=dev),
                 counts=torch.tensor(np.asarray(counts, np.int32),
                                     device=dev),
                 theta=p.theta, sqrt_c=p.sqrt_c, l_max=p.l_max)
    return SlingIndex(plan=p,
                      d=torch.tensor(np.asarray(d, np.float32), device=dev),
                      hp=hp, builder=builder, uncertified_d=uncertified_d)


def recsys_params_from_jax(cfg, params_np: dict, device=None):
    """The port's :class:`~repro_torch.models.recsys.XDeepFM` from the
    reference's ``init_params`` pytree as NumPy arrays ({"tables":
    {"embed", "linear"}, "recsys": {"cin_w": [..], "mlp_w": [..],
    "mlp_b": [..], "mlp_out", "cin_out", "bias"[, "sim_w"]}}), on
    ``device`` (``cuda`` unless ``device="cpu"``). ``cfg`` is the port's
    RecsysConfig with the reference's field values."""
    from repro_torch.models.recsys import XDeepFM
    dev = resolve_device(device)
    model = XDeepFM(cfg, generator=torch.Generator(device=dev))
    t, r = params_np["tables"], params_np["recsys"]
    src = {"tables.embed": t["embed"], "tables.linear": t["linear"],
           **{f"recsys.{k}": r[k] for k in ("mlp_out", "cin_out", "bias",
                                            "sim_w") if k in r},
           **{f"recsys.{k}.{i}": a for k in ("cin_w", "mlp_w", "mlp_b")
              for i, a in enumerate(r[k])}}
    _copy_named(model, src)
    return model


def _copy_named(model, src: dict) -> None:
    """Copy ``src`` ({parameter name: array}) into ``model``'s parameters,
    refusing other names or shapes."""
    own = dict(model.named_parameters())
    if set(src) != set(own):
        raise ValueError(f"parameter names differ: given {sorted(src)}, "
                         f"the model has {sorted(own)}")
    with torch.no_grad():
        for name, p in own.items():
            a = np.array(src[name], np.float32)     # a writable copy
            if a.shape != tuple(p.shape):
                raise ValueError(f"{name}: shape {a.shape}, expected "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(a))


def gnn_params_from_jax(cfg, params_np: dict, device=None):
    """The port's :class:`~repro_torch.models.gnn.GNNParams` from the
    reference's ``init_params`` pytree as NumPy arrays ({"gnn": {"w":
    [..], "b": [..], "a_src": [..], "w_pre": [..], "enc_grid", ...}}),
    on ``device`` (``cuda`` unless ``device="cpu"``). ``cfg`` is the
    port's GNNConfig with the reference's field values."""
    from repro_torch.models.gnn import GNNParams
    dev = resolve_device(device)
    model = GNNParams(cfg, generator=torch.Generator(device=dev))
    src = {}
    for k, v in params_np["gnn"].items():
        if isinstance(v, (list, tuple)):
            src.update({f"gnn.{k}.{i}": a for i, a in enumerate(v)})
        else:
            src[f"gnn.{k}"] = v
    _copy_named(model, src)
    return model


def lm_params_from_jax(cfg, params_np: dict, device=None):
    """The port's :class:`~repro_torch.models.transformer.LMParams` from
    the reference's ``init_params`` pytree as NumPy arrays ({"embed",
    "blocks": {"ln1", "wq", ...}, "ln_f"}), on ``device`` (``cuda``
    unless ``device="cpu"``). ``cfg`` is the port's LMConfig with the
    reference's field values."""
    from repro_torch.models.transformer import LMParams
    dev = resolve_device(device)
    model = LMParams(cfg, generator=torch.Generator(device=dev))
    src = {"embed": params_np["embed"], "ln_f": params_np["ln_f"],
           **{f"blocks.{k}": v for k, v in params_np["blocks"].items()}}
    _copy_named(model, src)
    return model


def adamw_state_from_jax(state_np, model):
    """The port's :class:`~repro_torch.optim.adamw.AdamWState` for
    ``model`` (an ``XDeepFM``, an ``LMParams`` or any tree
    ``adamw.named_leaves`` takes) from the reference's ``AdamWState``
    with NumPy leaves (``step``, and ``m`` and ``v`` shaped like the
    reference's parameters), on the model's device; m and v in
    float32."""
    from repro_torch.optim.adamw import AdamWState, named_leaves
    leaves = named_leaves(model)
    names = [n for n, _ in leaves]
    dev = leaves[0][1].device
    moments = []
    for field in ("m", "v"):
        src = dict(named_leaves(getattr(state_np, field)))
        if set(src) != set(names):
            raise ValueError(f"state {field} names differ: given "
                             f"{sorted(src)}, the model has {sorted(names)}")
        out = {}
        for n, p in leaves:
            a = np.array(src[n], np.float32)
            if a.shape != tuple(p.shape):
                raise ValueError(f"{field}/{n}: shape {a.shape}, expected "
                                 f"{tuple(p.shape)}")
            out[n] = torch.from_numpy(a).to(dev)
        moments.append(out)
    step = torch.tensor(int(np.asarray(state_np.step)), dtype=torch.int32,
                        device=dev)
    return AdamWState(step=step, m=moments[0], v=moments[1])
