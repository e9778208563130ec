"""Cell builder: (architecture x input shape) -> a step and its
arguments on a mesh (port of ``repro/launch/specs.py``).

Every cell yields a :class:`Cell`: the step function, its arguments as
``FakeTensor``s (shapes, dtypes and devices, no memory) made under one
``FakeTensorMode`` that :func:`make_cell` owns, their placements
(``launch/sharding.py``'s :class:`NamedSharding`, one for each leaf
under the reference's tree path), the donated arguments and the
analytic MODEL_FLOPS for the roofline's "useful compute" ratio.

The reference's ``Cell.jitted()`` hands the step to GSPMD, which
partitions it. The port partitions by hand, step by step: a step that
reads its placed pieces names its arguments in ``piecewise``, and
:meth:`Cell.jitted` hands it those pieces. The LMs' train, prefill
and decode steps, dense and MoE, read every argument so
(``models/transformer_sharded.py``: each position computes its batch
rows and sequence slice, or its cache slots, and the positions exchange
data through ``launch/collectives.py``), and so does the base GNN train
step of all four kinds (``models/gnn_sharded.py``: each position computes
its node rows and its edge slice); the shardmap GCN
(``gcn_loss_sharded``) reads its batch, the SLING pod path
(``sling_serve_step_sharded``) its graph blocks. The recsys steps still
take whole tensors: :meth:`Cell.jitted` gathers each of their arguments
to the mesh's first device (a copy the op walk counts as collective
"gather"; a replicated leaf is read from the first device's own copy).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch import nn

from repro_torch.configs import base as cfg_base
from repro_torch.kernels import cost as _cost
from repro_torch.launch import sharding as sh
from repro_torch.optim.adamw import AdamW, AdamWState

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


# ----------------------------------------------------------------------
# the cell and its placed arguments
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Placed:
    """One argument placed on a mesh: the caller's object (``template``:
    a module, an AdamW state or a dict) and {tree path: its leaf placed
    as a :class:`~repro_torch.launch.sharding.ShardedTensor`, or as is
    where the placement is None}."""
    template: Any
    leaves: dict


@dataclasses.dataclass
class Cell:
    """A step on a mesh. ``args`` are fake tensors; ``in_shardings`` /
    ``out_shardings`` hold, for each argument or output, {tree path:
    NamedSharding or None} (None: the reference lets GSPMD choose, and
    the port returns whatever its step returns). ``donate_argnums``:
    the arguments the step updates in place. ``piecewise``: the
    arguments whose placed pieces the step reads itself; every other
    argument is gathered to the mesh's first device."""
    arch_id: str
    shape_name: str
    fn: Callable
    args: tuple
    in_shardings: tuple
    out_shardings: Any
    donate_argnums: tuple
    model_flops: float            # analytic useful FLOPs per step
    rules: Optional[dict] = None  # logical-rule overrides used
    mesh: Any = None
    piecewise: tuple = ()

    def place(self, args=None) -> tuple:
        """``args`` (the cell's own fake arguments when None, or real
        tensors of the same tree) placed as ``in_shardings`` say: one
        :class:`Placed` an argument."""
        args = self.args if args is None else args
        out = []
        for arg, shard in zip(args, self.in_shardings):
            leaves = dict(sh.tree_paths(arg))
            if set(leaves) != set(shard):
                raise ValueError(f"{self.arch_id} x {self.shape_name}: "
                                 f"argument leaves {list(leaves)} do not "
                                 f"match the cell's {list(shard)}")
            out.append(Placed(arg, {
                p: leaf if shard[p] is None else shard[p].shard(leaf)
                for p, leaf in leaves.items()}))
        return tuple(out)

    def jitted(self) -> Callable:
        """The step over placed arguments (:meth:`place`): each leaf is
        checked against ``in_shardings``; an argument in ``piecewise``
        reaches the step with its placed leaves (a module as {tree path:
        its placed leaf}), every other one whole on the mesh's first
        device; then ``fn`` runs under the cell's mesh and rules."""
        home = self.mesh.flat[0]

        def call(*placed):
            if len(placed) != len(self.args):
                raise TypeError(f"the step takes {len(self.args)} placed "
                                f"arguments, got {len(placed)}")
            args = []
            for i, (p, shard) in enumerate(zip(placed, self.in_shardings)):
                if set(p.leaves) != set(shard):
                    raise ValueError(f"argument {i}: leaves "
                                     f"{list(p.leaves)}, the cell's "
                                     f"{list(shard)}")
                vals = {}
                for path, leaf in p.leaves.items():
                    ns = shard[path]
                    got = getattr(leaf, "sharding", None)
                    if ns is not None and got != ns:
                        raise ValueError(f"argument {i} leaf {path}: placed "
                                         f"as {got}, the cell's {ns}")
                    vals[path] = leaf if ns is None or i in self.piecewise \
                        else whole(leaf, home)
                args.append(vals if i in self.piecewise and isinstance(
                    p.template, nn.Module) else rebuild(p.template, vals))
            with sh.use_mesh_rules(self.mesh, self.rules):
                return self.fn(*args)
        return call


def whole(st: "sh.ShardedTensor", device) -> torch.Tensor:
    """A placed tensor whole on ``device``: the first position's piece
    itself where it is the whole tensor on that device (a replicated
    leaf), else gathered there (collective kind "gather")."""
    first = next(iter(st.pieces.values()))
    if tuple(first.shape) == st.shape and first.device == device:
        return first
    with _cost.collective("gather"):
        return st.gather(device)


def _same_view(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True when real tensors ``a`` and ``b`` view the same elements."""
    from repro_torch.kernels.cost import is_fake
    return a is b or (not is_fake(a, b) and a.device == b.device
                      and a.data_ptr() == b.data_ptr()
                      and a.shape == b.shape and a.stride() == b.stride())


def _set_param(module: nn.Module, path: str, v: torch.Tensor) -> None:
    """Replace the parameter at tree path ``path`` of ``module`` by one
    over ``v`` (the same ``requires_grad``)."""
    *parts, last = path.split("/")
    owner = module
    for part in parts:
        owner = owner[int(part)] if isinstance(
            owner, (nn.ModuleList, nn.ParameterList)) else getattr(owner, part)
    old = owner[int(last)] if isinstance(owner, nn.ParameterList) \
        else getattr(owner, last)
    new = nn.Parameter(v, requires_grad=old.requires_grad)
    if isinstance(owner, nn.ParameterList):
        owner[int(last)] = new
    else:
        setattr(owner, last, new)


def rebuild(template, vals: dict):
    """``template`` with its leaves (by tree path) taken from ``vals``: a
    module's parameters replaced by parameters over them in place (a
    module argument is donated; a leaf that already is the parameter's
    own tensor stays), an AdamW state or a dict rebuilt."""
    if isinstance(template, nn.Module):
        named = dict(sh.tree_paths(template))
        for path, v in vals.items():
            if not _same_view(named[path], v):
                _set_param(template, path, v)
        return template
    if isinstance(template, AdamWState):
        m = rebuild(template.m, {k[3:]: v for k, v in vals.items()
                                 if k.startswith(".m/")})
        v_ = rebuild(template.v, {k[3:]: v for k, v in vals.items()
                                  if k.startswith(".v/")})
        return AdamWState(step=vals[".step"], m=m, v=v_)
    if isinstance(template, dict):
        out = {}
        for k, sub in template.items():
            if isinstance(sub, (dict, list)):
                pre = f"{k}/"
                out[k] = rebuild(sub, {p[len(pre):]: v for p, v in vals.items()
                                       if p.startswith(pre)})
            else:
                out[k] = vals[k]
        return out
    if isinstance(template, list):
        return [rebuild(sub, {p[len(f"{i}/"):]: v for p, v in vals.items()
                              if p.startswith(f"{i}/")})
                if isinstance(sub, (dict, list)) else vals[str(i)]
                for i, sub in enumerate(template)]
    raise TypeError(f"cannot rebuild a {type(template).__name__}")


def _ns(mesh, *parts):
    return sh.NamedSharding(mesh, tuple(parts))


def _pad512(x: int) -> int:
    """The reference's padding of graph and candidate arrays to a
    multiple of 512, the lcm of both production mesh sizes (its
    in_shardings need exact division); the port pads the same."""
    return -(-x // 512) * 512


def _batch_shardings(mesh, tree_of_names: dict, shapes: dict):
    return {k: sh.NamedSharding(mesh, sh.spec_for(tuple(shapes[k].shape),
                                                  names, mesh))
            for k, names in tree_of_names.items()}


def _opt_ns(opt_state, pshard: dict, mesh) -> dict:
    """The AdamW state's placements: the step replicated, m and v as the
    parameters (the reference's ``AdamWState(step=_ns(mesh), m=pshard,
    v=pshard)``)."""
    return {p: _ns(mesh) if p == ".step" else pshard[p[3:]]
            for p, _ in sh.tree_paths(opt_state)}


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype)


# ----------------------------------------------------------------------
# cell constructors
# ----------------------------------------------------------------------
def make_cell(arch_id: str, shape_name: str, mesh,
              rules: Optional[dict] = None,
              variant: str = "base") -> Cell:
    """The cell of ``arch_id`` x ``shape_name`` on ``mesh``; its
    arguments are fake tensors made under a ``FakeTensorMode`` of its
    own. ``variant="shardmap"`` takes the GCN's node-sharded step. The
    SLING cell is the pod path's, as in the reference."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    spec = cfg_base.get(arch_id)
    with FakeTensorMode():
        if spec.family == "lm":
            return _lm_cell(spec, shape_name, mesh, rules)
        if spec.family == "gnn":
            if variant == "shardmap":
                return _gnn_cell_shardmap(spec, shape_name, mesh, rules)
            return _gnn_cell(spec, shape_name, mesh, rules)
        if spec.family == "recsys":
            return _recsys_cell(spec, shape_name, mesh, rules)
        if spec.family == "sling":
            return _sling_cell(spec, shape_name, mesh, rules)
    raise ValueError(spec.family)


def lm_rules(kind: str, batch: int, rules: Optional[dict] = None) -> dict:
    """The LM cells' rule overrides on top of ``rules``: prefill's output
    cache splits its sequence over "model"; decode splits the cache's
    sequence over "model" (over the data axes too at batch 1) and leaves
    heads and head_dim whole."""
    if kind == "prefill":
        # output KV cache shards its sequence axis over "model"
        return dict(rules or {}, **{"kv_seq": [("model",)]})
    if kind == "decode":
        # split-KV ("flash decoding"): the cache's sequence axis carries
        # the model axis (data too when batch=1); heads/head_dim stay
        # unsharded so score contractions are local
        decode_rules = {"kv_seq": [("model",)], "heads": [None],
                        "kv_heads": [None], "head_dim": [None],
                        "q_seq": [None]}
        if batch == 1:
            decode_rules["kv_seq"] = [("pod", "data", "model"),
                                      ("data", "model")]
        return dict(rules or {}, **decode_rules)
    return rules


def _lm_cell(spec, shape_name, mesh, rules) -> Cell:
    """An LM cell: its steps read their placed pieces
    (``models/transformer_sharded.py``), dense and MoE configs alike."""
    from repro_torch.models import transformer as T
    from repro_torch.train import steps
    d = LM_SHAPE_DEFS[shape_name]
    cfg = spec.full()
    opt = AdamW(lr=1e-4)
    rules = lm_rules(d["kind"], d["batch"], rules)
    with sh.use_mesh_rules(mesh, rules):
        params = T.init_params(cfg, torch.Generator().manual_seed(0))
        pshard = sh.tree_shardings(params, mesh)
        if d["kind"] == "train":
            opt_state = opt.init(params)
            oshard = _opt_ns(opt_state, pshard, mesh)
            batch = {"targets": _empty((d["batch"], d["seq"]), torch.int32),
                     "tokens": _empty((d["batch"], d["seq"]), torch.int32)}
            bshard = _batch_shardings(mesh, {k: ("batch", "seq")
                                             for k in batch}, batch)
            fn = steps.lm_train_step_sharded(cfg, opt)
            return Cell(spec.arch_id, shape_name, fn,
                        (params, opt_state, batch),
                        (pshard, oshard, bshard),
                        (pshard, oshard, {"loss": _ns(mesh)}),
                        donate_argnums=(0, 1),
                        model_flops=lm_model_flops(cfg, "train", d["batch"],
                                                   d["seq"]),
                        rules=rules, mesh=mesh,
                        piecewise=(0, 1, 2))
        if d["kind"] == "prefill":
            batch = {"tokens": _empty((d["batch"], d["seq"]), torch.int32)}
            bshard = _batch_shardings(mesh, {"tokens": ("batch", "seq")},
                                      batch)
            fn = steps.lm_prefill_step_sharded(cfg)
            return Cell(spec.arch_id, shape_name, fn, (params, batch),
                        (pshard, bshard), None, (),
                        lm_model_flops(cfg, "prefill", d["batch"], d["seq"]),
                        rules, mesh, piecewise=(0, 1))
        # decode
        B, Sq = d["batch"], d["seq"]
        cshape = (cfg.n_layers, B, Sq, cfg.n_kv_heads, cfg.d_head)
        cnames = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
        cache = {"k": _empty(cshape, cfg.dtype),
                 "len": _empty((), torch.int32),
                 "v": _empty(cshape, cfg.dtype)}
        cspec = sh.spec_for(cshape, cnames, mesh)
        cshard = {"k": sh.NamedSharding(mesh, cspec), "len": _ns(mesh),
                  "v": sh.NamedSharding(mesh, cspec)}
        batch = {"token": _empty((B,), torch.int32)}
        bshard = _batch_shardings(mesh, {"token": ("batch",)}, batch)
        fn = steps.lm_decode_step_sharded(cfg)
        logits_shard = sh.NamedSharding(
            mesh, sh.spec_for((B, cfg.vocab), ("batch", "vocab"), mesh))
        out = {"cache/k": cshard["k"], "cache/len": cshard["len"],
               "cache/v": cshard["v"], "logits": logits_shard}
        return Cell(spec.arch_id, shape_name, fn, (params, cache, batch),
                    (pshard, cshard, bshard), out, (1,),
                    lm_model_flops(cfg, "decode", B, Sq), rules, mesh,
                    piecewise=(0, 1, 2))


def _gnn_cell(spec, shape_name, mesh, rules) -> Cell:
    """A GNN train cell: its step reads its placed pieces
    (``models/gnn_sharded.py``: each position computes its node rows and
    its edge slice), the four kinds alike."""
    from repro_torch.models import gnn as G
    from repro_torch.train import steps
    d = GNN_SHAPE_DEFS[shape_name]
    cfg = dataclasses.replace(spec.full(), d_in=d["d_feat"])
    opt = AdamW(lr=1e-3)
    flops = gnn_model_flops(cfg, d["n"], d["m"], d["d_feat"])
    n, m = _pad512(d["n"]), _pad512(d["m"])
    f32, i32 = torch.float32, torch.int32
    with sh.use_mesh_rules(mesh, rules):
        params = G.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        pshard = sh.tree_shardings(params, mesh)
        opt_state = opt.init(params)
        oshard = _opt_ns(opt_state, pshard, mesh)
        if cfg.kind == "graphcast":
            n_tot = 2 * n
            batch = {
                "feats": _empty((n_tot, d["d_feat"]), f32),
                "edge_src": _empty((m,), i32),
                "edge_dst": _empty((m,), i32),
                "edge_mask": _empty((m,), f32),
                "node_mask": _empty((n_tot,), f32),
                "n_grid": _empty((), i32),
                "g2m_src": _empty((2 * n,), i32),
                "g2m_dst": _empty((2 * n,), i32),
                "g2m_mask": _empty((2 * n,), f32),
                "m2g_src": _empty((2 * n,), i32),
                "m2g_dst": _empty((2 * n,), i32),
                "m2g_mask": _empty((2 * n,), f32),
                "targets": _empty((n_tot, cfg.n_vars), f32),
            }
            names = {
                "feats": ("nodes", "feat"), "edge_src": ("edges",),
                "edge_dst": ("edges",), "edge_mask": ("edges",),
                "node_mask": ("nodes",), "n_grid": (),
                "g2m_src": ("edges",), "g2m_dst": ("edges",),
                "g2m_mask": ("edges",), "m2g_src": ("edges",),
                "m2g_dst": ("edges",), "m2g_mask": ("edges",),
                "targets": ("nodes", "feat"),
            }
        else:
            batch = {
                "feats": _empty((n, d["d_feat"]), f32),
                "edge_src": _empty((m,), i32),
                "edge_dst": _empty((m,), i32),
                "edge_mask": _empty((m,), f32),
                "node_mask": _empty((n,), f32),
                "labels": _empty((n,), i32),
            }
            names = {
                "feats": ("nodes", "feat"), "edge_src": ("edges",),
                "edge_dst": ("edges",), "edge_mask": ("edges",),
                "node_mask": ("nodes",), "labels": ("nodes",),
            }
        batch = dict(sorted(batch.items()))
        bshard = _batch_shardings(mesh, {k: names[k] for k in batch}, batch)
        fn = steps.gnn_train_step_sharded(cfg, opt)
        return Cell(spec.arch_id, shape_name, fn,
                    (params, opt_state, batch),
                    (pshard, oshard, bshard),
                    (pshard, oshard, {"loss": _ns(mesh)}), (0, 1),
                    flops, rules, mesh, piecewise=(0, 1, 2))


def _gnn_cell_shardmap(spec, shape_name, mesh, rules) -> Cell:
    """Optimized GCN cell: dst-partitioned edges and node-sharded
    message passing (``models/gnn_sharded.gcn_loss_sharded``), which
    reads each shard's rows and edge block from the placed batch."""
    from repro_torch.models import gnn as G
    from repro_torch.models.gnn_sharded import gcn_loss_sharded
    from repro_torch.train.trainer import value_and_grad
    d = GNN_SHAPE_DEFS[shape_name]
    cfg = dataclasses.replace(spec.full(), d_in=d["d_feat"])
    assert cfg.kind == "gcn", "shardmap variant implemented for GCN"
    opt = AdamW(lr=1e-3)
    flops = gnn_model_flops(cfg, d["n"], d["m"], d["d_feat"])
    n = _pad512(d["n"])
    ns = _mesh_size(mesh)
    e_max = int(-(-int(d["m"] * 1.3 / ns) // 8) * 8)
    f32, i32 = torch.float32, torch.int32
    with sh.use_mesh_rules(mesh, rules):
        params = G.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        pshard = sh.tree_shardings(params, mesh)
        opt_state = opt.init(params)
        oshard = _opt_ns(opt_state, pshard, mesh)
        axes = tuple(a for a in ("pod", "data", "model")
                     if a in mesh.shape and mesh.shape[a] > 1)
        batch = {
            "blk_dstl": _empty((ns, e_max), i32),
            "blk_src": _empty((ns, e_max), i32),
            "blk_w": _empty((ns, e_max), f32),
            "feats": _empty((n, d["d_feat"]), f32),
            "labels": _empty((n,), i32),
            "node_mask": _empty((n,), f32),
            "w_self": _empty((n,), f32),
        }
        bshard = {k: _ns(mesh, axes, *([None] * (v.dim() - 1)))
                  for k, v in batch.items()}

        def step(params, opt_state, batch):
            loss, grads = value_and_grad(
                lambda p, b: gcn_loss_sharded(cfg, p, b), params, batch)
            params, opt_state = opt.update(grads, opt_state, params)
            return params, opt_state, {"loss": loss}

        return Cell(spec.arch_id, shape_name + "+shardmap", step,
                    (params, opt_state, batch),
                    (pshard, oshard, bshard),
                    (pshard, oshard, {"loss": _ns(mesh)}), (0, 1), flops,
                    rules, mesh, piecewise=(2,))


def _mesh_size(mesh) -> int:
    n = 1
    for s in mesh.shape.values():
        n *= s
    return n


def _recsys_cell(spec, shape_name, mesh, rules) -> Cell:
    from repro_torch.models import recsys as R
    from repro_torch.train import steps
    d = RECSYS_SHAPE_DEFS[shape_name]
    cfg = spec.full()
    i32 = torch.int32
    with sh.use_mesh_rules(mesh, rules):
        params = R.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        pshard = sh.tree_shardings(params, mesh)
        if d["kind"] == "retrieval":
            C = _pad512(d["n_candidates"])
            n_item = cfg.n_fields - cfg.n_user_fields
            batch = {"cand_ids": _empty((C, n_item), i32),
                     "user_ids": _empty((cfg.n_user_fields,), i32)}
            bshard = {"cand_ids": sh.NamedSharding(
                          mesh, sh.spec_for((C, n_item),
                                            ("candidates", "fields"), mesh)),
                      "user_ids": _ns(mesh)}
            fn = steps.recsys_retrieval_step(cfg)
            return Cell(spec.arch_id, shape_name, fn, (params, batch),
                        (pshard, bshard), None, (),
                        recsys_model_flops(cfg, C, train=False), rules, mesh)
        B = d["batch"]
        batch = {"ids": _empty((B, cfg.n_fields), i32),
                 "mh_ids": _empty((B, cfg.multi_hot_fields, cfg.bag_size),
                                  i32)}
        bnames = {"ids": ("batch", "fields"),
                  "mh_ids": ("batch", "fields", None)}
        if d["kind"] == "train":
            batch["labels"] = _empty((B,), i32)
            bnames["labels"] = ("batch",)
            batch = dict(sorted(batch.items()))
            opt = AdamW(lr=1e-3)
            opt_state = opt.init(params)
            oshard = _opt_ns(opt_state, pshard, mesh)
            bshard = _batch_shardings(mesh, {k: bnames[k] for k in batch},
                                      batch)
            fn = steps.recsys_train_step(cfg, opt)
            return Cell(spec.arch_id, shape_name, fn,
                        (params, opt_state, batch),
                        (pshard, oshard, bshard),
                        (pshard, oshard, {"loss": _ns(mesh)}), (0, 1),
                        recsys_model_flops(cfg, B, train=True), rules, mesh)
        bshard = _batch_shardings(mesh, bnames, batch)
        fn = steps.recsys_serve_step(cfg)
        return Cell(spec.arch_id, shape_name, fn, (params, batch),
                    (pshard, bshard), None, (),
                    recsys_model_flops(cfg, B, train=False), rules, mesh)


def _sling_cell(spec, shape_name, mesh, rules,
                variant: str = "shardmap") -> Cell:
    """The SLING serving cell. ``"shardmap"``: the pod path over the
    reference's destination-partitioned edge blocks, which it reads
    piece by piece. ``"base"``: ``sling_serve_step``, whose graph is Â's
    ``SpmmLayout`` (built on the mesh's first device, a form that holds
    no placement) where the reference passes edge_src / edge_dst / w."""
    from repro_torch.kernels.spmv_ell import SpmmLayout
    from repro_torch.train import steps
    cfg = spec.full()
    cfg = dataclasses.replace(cfg, n=_pad512(cfg.n), m=_pad512(cfg.m))
    n, m, W, B = cfg.n, cfg.m, cfg.hp_width, cfg.batch
    f32, i32 = torch.float32, torch.int32
    with sh.use_mesh_rules(mesh, rules):
        index = {"d": _empty((n,), f32), "keys": _empty((n, W), i32),
                 "vals": _empty((n, W), f32)}
        batch = {"us": _empty((B,), i32)}
        # useful flops: L pushes of 2m MACs per query + seed scatter
        flops = 2.0 * B * cfg.l_max * m
        row = sh.NamedSharding(mesh, sh.spec_for((n, W), ("nodes", None),
                                                 mesh))
        ishard = {"d": sh.NamedSharding(mesh, sh.spec_for((n,), ("nodes",),
                                                          mesh)),
                  "keys": row, "vals": row}
        bshard = _batch_shardings(mesh, {"us": ("batch",)}, batch)
        if variant == "shardmap":
            ns_m = mesh.shape["model"]
            e_max = int(-(-int(m * 1.3 / ns_m) // 8) * 8)
            graph = {"blk_dstl": _empty((ns_m, e_max), i32),
                     "blk_src": _empty((ns_m, e_max), i32),
                     "blk_w": _empty((ns_m, e_max), f32)}
            gshard = {k: _ns(mesh, ("model",), None) for k in graph}
            # index rows are gathered per query batch: replicate d,
            # shard keys/vals over nodes as before
            fn = steps.sling_serve_step_sharded(cfg, mesh)
            ishard["d"] = _ns(mesh)
            return Cell(spec.arch_id, shape_name + "+shardmap", fn,
                        (index, graph, batch), (ishard, gshard, bshard),
                        None, (), flops, rules, mesh, piecewise=(1,))
        home = mesh.flat[0]
        layout = SpmmLayout(
            n=n, in_ptr=torch.empty((n + 1,), dtype=i32, device=home),
            in_idx=torch.empty((m,), dtype=i32, device=home),
            w=torch.empty((m,), dtype=f32, device=home),
            heavy=torch.empty((0,), dtype=i32, device=home),
            light=torch.empty((n,), dtype=i32, device=home))
        fn = steps.sling_serve_step(cfg)
        return Cell(spec.arch_id, shape_name, fn,
                    (index, {"layout": layout}, batch),
                    (ishard, {"layout": None}, bshard), None, (),
                    flops, rules, mesh)
