"""The LM's train, prefill and decode steps on the placed pieces of their
arguments: by hand, what GSPMD derives for the reference from its
``logical(...)`` hints (``repro/models/transformer.py``,
``repro/models/flash_attention.py``, ``repro/models/moe.py``) on the same
placements (``launch/sharding.py``'s ``PARAM_RULES``, the cell's rules).

Each mesh position runs one program, position by position in row-major
order from the calling thread, and the positions exchange data through
``launch/collectives.py``. The parameters arrive as {tree path:
``ShardedTensor``} (:func:`place_params`); the batch and the cache as
``ShardedTensor`` s too, or whole, and are then placed by the active
rules. Let D be the data axes ("pod", "data") and M the "model" axis;
position (g, j) is data group g, model index j.

* Train (:func:`value_and_grad`). The position takes the batch rows of
  group g (its piece of the tokens) and the sequence slice j of S (cut by
  ``launch.sharding._bounds``, unevenly where M does not divide S). Every
  token-local op runs on that slice: the embedding, the norms, the
  projections, the dense FFN and the loss chunks (its slice cut at the
  global ``loss_chunk`` boundaries). Attention reads the group's whole K
  and V, all-gathered over M (the reference's ``kv_time: [None]``),
  against its own queries at their offset (``q_seq: [("model",)]``;
  ``flash_attention``'s ``q_offset``). A layer's weights are gathered
  whole in ``cfg.dtype`` inside that layer's checkpointed function, so
  the remat gathers them again in the backward and only one layer is
  whole at a time; ``embed`` and ``ln_f`` are gathered once. The
  gather's backward is the reduce-scatter: each piece's gradient is the
  sum of every position's gradient at its region, in row-major position
  order, in float32 (a replicated leaf, the norms, gets the sum on every
  copy). The embedding lookup's gradient adds each id's rows up in
  float32 (``_Lookup``). A loss chunk's logits are formed
  ``VOCAB_SLICE`` rows of the vocabulary at a time
  (:func:`_chunk_nll_sliced`), never whole. The
  loss is the positions' NLL sums, all-reduced in position order, over
  B * S.
* The MoE FFN (train and prefill) is a group-level step, the reference's
  ``shard_map`` branch with GSPMD's "model" split written out: the
  group's tokens (its rows, the whole sequence: the block one data shard
  dispatches) are all-gathered over M; every position routes them alike
  (``models/moe.dispatch``, capacity ``ceil(T_l * k / E * cf)``). The
  expert weights are gathered over the axes but M only, so a position
  holds its experts (EP: M splits the experts) or every expert's slice of
  d_ff (TP: M splits d_ff). It forms its partial y (T_l, d) in float32
  from its pieces; a reduce-scatter over M sums the partials and gives
  each position its sequence slice in ``cfg.dtype``. Each position adds
  aux / M to the loss's all-reduce; the loss takes 0.01 x the layers'
  sum over the G groups' mean, as the reference's ``lm_loss``.
* Prefill (:func:`prefill`). The same split, without gradients. The
  position's own K and V slice is its piece of the output cache
  (``kv_seq: [("model",)]``): the cache is never whole. The last-token
  logits come from the position holding the last slice and are copied
  to its group's other positions.
* Decode (:func:`decode_step`). The cache's placement says what a
  position holds: its batch rows (over D when the batch divides) and its
  slots (over M, and over D too at batch 1). Weights stay on their
  pieces and activations move: a weight is gathered over the axes that
  split the rows only; a position multiplies its slice with the matching
  slice of its rows, the partials of a contraction split over other
  axes are all-reduced (in position order, in float32, cast once to
  ``cfg.dtype``), and an output split over other axes is all-gathered:
  q and the new k / v over M (putting split heads or head_dims back
  together), the ``wo`` and ``w_down`` partials all-reduced over M; at
  batch 1 every weight is read as its own piece and the partials are
  summed over D. The new key and value are written only where slot
  ``len`` lives (``len`` read once a step). Each position forms its
  partial softmax (max, sum, weighted V, in float32) over its slots; the
  partials merge across the slot axes by log-sum-exp in position order.
  The logits come out placed (batch, vocab): a position computes only
  its vocab slice. An MoE layer routes each position's rows on their own
  (its rows are its data group's; at batch 1, or where the groups do not
  divide the batch, the whole batch is one group, as in the reference);
  the experts run on their pieces in the same patterns, the EP or TP
  partial y all-reduced over M.

A dry run (fake tensors on distinct devices) runs one program for each
class of positions whose programs have equal shapes
(``collectives.spmd``): the key holds a position's rows, slice, loss
chunks, role (the last slice, the slot ``len``) and its pieces' shapes.
"""
from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.kernels.cost import host_read, is_fake, worst_case
from repro_torch.launch import collectives as C
from repro_torch.launch import sharding as sh
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.models.flash_attention import flash_attention
from repro_torch.models.layers import rms_norm, rope, silu

NORMS = ("ln1", "ln2", "qnorm", "knorm")
EXPERTS = ("moe_w_gate", "moe_w_up", "moe_w_down")
# rows of ``embed`` a loss slice: its float32 logits take 256 MiB at a
# position of the gemma3-1b train_4k cell at 16 x 16 (16 rows x 256 tokens)
VOCAB_SLICE = 4_096


def _mesh():
    mesh = sh.active_mesh()
    if mesh is None:
        raise ValueError("the partitioned LM step needs an active mesh "
                         "(launch.sharding.use_mesh_rules)")
    return mesh


def _axes(entry) -> tuple:
    return () if not entry else tuple(entry)


def _data_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data")
                 if a in mesh.shape and mesh.shape[a] > 1)


def _model_axes(mesh) -> tuple:
    return ("model",) if "model" in mesh.shape else ()


@functools.lru_cache(maxsize=None)
def _regions(sharding, shape: tuple) -> dict:
    """{position: ((lo, hi), ...)} of a placed tensor's pieces."""
    return {p: tuple((s.start, s.stop) for s in sl)
            for p, sl in sharding.devices_indices_map(shape).items()}


def place_params(params, mesh=None) -> dict:
    """{tree path: ShardedTensor} of an ``LMParams`` under the active
    rules (``launch.sharding.tree_shardings``); a dict of placed leaves
    is returned as it is. A piece already on its device is a view of the
    leaf: the train step updates it in place."""
    if isinstance(params, dict):
        return params
    mesh = mesh or _mesh()
    shards = sh.tree_shardings(params, mesh)
    return {path: shards[path].shard(leaf.detach())
            for path, leaf in sh.tree_paths(params)}


def _placed(x, names, mesh) -> sh.ShardedTensor:
    """``x`` as a ShardedTensor: placed as given, or placed here by the
    active rules for its logical ``names``."""
    if isinstance(x, sh.ShardedTensor):
        return x
    x = torch.as_tensor(x)
    return sh.place(x, sh.spec_for(tuple(x.shape), names, mesh), mesh)


def _block_names(leaves: dict) -> list:
    return [p.split("/", 1)[1] for p in leaves if p.startswith("blocks/")]


def _whole(S, st, parts, l, dtype, what):
    """{p: leaf ``st``'s layer ``l`` (the leaf itself when None) whole on
    p's device, in ``dtype``} from ``parts`` {p: p's piece}; gathered
    over the axes that split it, its gradient summed over every
    position."""
    regs = _regions(st.sharding, st.shape)
    axes = {a for e in st.sharding.spec for a in _axes(e)}
    drop = 0 if l is None else 1
    full = tuple(st.shape[drop:])
    src = parts if l is None else {p: parts[p][l] for p in S.run}
    return C.all_gather(S, src, tuple(axes), lambda q: regs[q][drop:],
                        lambda p: full, dtype=dtype,
                        readers=S.mesh.axis_names, what=what)


def _gather_over(S, st, parts, l, axes, dtype, name):
    """({p: leaf ``st``'s layer ``l`` piece (the leaf itself when None)
    gathered whole along the dimensions split over ``axes``, in
    ``dtype``}, q -> the region of q's gathered piece in the layer, [the
    axes still splitting each dimension]). Under autograd a piece's gradient sums the
    gradients at its region of every position that reads it (each other
    axis but those still splitting it)."""
    drop = 0 if l is None else 1
    spec = (tuple(st.sharding.spec) + (None,) * len(st.shape))[
        drop:len(st.shape)]
    shape = tuple(st.shape[drop:])
    regs = _regions(st.sharding, st.shape)
    axes = set(axes)
    for e in spec:
        if set(_axes(e)) & axes and not set(_axes(e)) <= axes:
            raise ValueError(f"{name} is placed {st.sharding.spec}: a "
                             "dimension split partly over the axes "
                             f"{sorted(axes)}")
    gdims = [i for i, e in enumerate(spec) if e and set(e) <= axes]
    gaxes = tuple(a for i in gdims for a in spec[i])
    left = [() if i in gdims else _axes(e) for i, e in enumerate(spec)]

    def eff(q):
        r = regs[q][drop:]
        return tuple((0, n) if i in gdims else r[i]
                     for i, n in enumerate(shape))
    src = {p: parts[p] if l is None else parts[p][l] for p in S.run}
    if gaxes or torch.is_grad_enabled():
        def gregion(q):
            r = regs[q][drop:]
            return tuple(r[i] if i in gdims else (0, r[i][1] - r[i][0])
                         for i in range(len(shape)))
        split = {a for e in left for a in e}
        W = C.all_gather(S, src, gaxes, gregion,
                         lambda p: tuple(b - a for a, b in eff(p)),
                         dtype=dtype, what=f"{name}@{','.join(gaxes)}",
                         readers=tuple(a for a in S.mesh.axis_names
                                       if a not in split))
    else:
        W = {p: src[p].to(dtype) for p in S.run}
    return W, eff, left


class _SlicedNLL(torch.autograd.Function):
    """The summed NLL of a chunk, its logits formed ``width`` vocabulary
    rows at a time: an online log-sum-exp over the slices, the gold logit
    from the slice that holds each target; the backward recomputes each
    slice's logits and adds (softmax - onehot) g into dx and that slice
    of d emb."""

    @staticmethod
    def forward(ctx, xi, ti, emb, width):
        V = emb.shape[0]
        tl = ti.long()
        m = s = gold = None
        for v0 in range(0, V, width):
            v1 = min(V, v0 + width)
            lg = (xi @ emb[v0:v1].T).to(torch.float32)
            top = lg.amax(-1)
            if m is None:
                m, s = top, torch.exp(lg - top[..., None]).sum(-1)
            else:
                new = torch.maximum(m, top)
                s = s * torch.exp(m - new) \
                    + torch.exp(lg - new[..., None]).sum(-1)
                m = new
            hit = (tl >= v0) & (tl < v1)
            at = torch.clamp(tl - v0, 0, v1 - v0 - 1)
            g = lg.gather(-1, at[..., None])[..., 0]
            gold = torch.where(hit, g, 0.0 if gold is None else gold)
            del lg
        logz = m + torch.log(s)
        ctx.width = width
        ctx.save_for_backward(xi, ti, emb, logz)
        return (logz - gold).sum()

    @staticmethod
    def backward(ctx, g):
        xi, ti, emb, logz = ctx.saved_tensors
        V, d = emb.shape
        tl = ti.long()
        dx = torch.zeros(xi.shape, dtype=torch.float32, device=xi.device)
        demb = torch.empty_like(emb)
        rows = xi.reshape(-1, d)
        for v0 in range(0, V, ctx.width):
            v1 = min(V, v0 + ctx.width)
            lg = (xi @ emb[v0:v1].T).to(torch.float32)
            ids = torch.arange(v0, v1, device=tl.device)
            p = torch.exp(lg - logz[..., None]) \
                - (ids == tl[..., None]).to(torch.float32)
            dl = (p * g).to(xi.dtype)
            del lg, p
            dx += (dl @ emb[v0:v1]).to(torch.float32)
            demb[v0:v1] = dl.reshape(-1, v1 - v0).T @ rows
        return dx.to(xi.dtype), None, demb, None


class _Lookup(torch.autograd.Function):
    """``table.index_select(0, ids)``; the backward adds each id's rows up
    in float32 (in a (n, d) buffer, a row a run of equal ids after a
    sort) and casts each sum once into the table's gradient, as the
    unpartitioned step's lookup from the float32 table adds them (a
    frequent token's thousands of rows added in bf16 swamp)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.meta = (tuple(table.shape), table.dtype)
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        shape, dtype = ctx.meta
        srt, order = torch.sort(ids)
        new = torch.ones_like(srt, dtype=torch.bool)
        new[1:] = srt[1:] != srt[:-1]
        run = torch.cumsum(new, 0) - 1
        acc = torch.zeros((ids.numel(), g.shape[-1]), dtype=torch.float32,
                          device=g.device).index_add_(
            0, run, g.index_select(0, order).to(torch.float32))
        # a run past the last holds zeros and adds them to row 0
        rep = torch.zeros_like(srt).scatter_(0, run, srt)
        return torch.zeros(shape, dtype=dtype, device=g.device).index_add_(
            0, rep, acc.to(dtype)), None


def _chunk_nll_sliced(xi, ti, emb, width: int):
    """``transformer._chunk_nll`` (the summed NLL of a (rows, c) chunk
    over the tied embeddings) with no (rows, c, V) logits in either
    direction: ``width`` rows of ``emb`` at a time (the last slice may
    be short). Only the order of the log-sum-exp's sum differs."""
    return _SlicedNLL.apply(xi, ti, emb, width)


# ----------------------------------------------------------------------
# the MoE FFN over a position's pieces
# ----------------------------------------------------------------------
def _expert_weights(cfg, S, leaves, parts, l, axes):
    """{name: {p: expert weight ``name``'s layer l piece gathered over
    ``axes``, in cfg.dtype}}, p -> the gate's region ((e0, e1), (d0, d1),
    (f0, f1)), and the axes still splitting the experts, d and d_ff,
    which must agree across the three weights."""
    W, split = {}, None
    for n in EXPERTS:
        W[n], reg, left = _gather_over(S, leaves["blocks/" + n],
                                       parts["blocks/" + n], l, axes,
                                       cfg.dtype, "blocks/" + n)
        e, a, b = left
        by_dim = (e, a, b) if n != "moe_w_down" else (e, b, a)
        if split is None:
            split, regs = by_dim, reg
        elif by_dim != split:
            raise ValueError(f"the expert weights are placed apart: "
                             f"{n} splits (experts, d, d_ff) over {by_dim}, "
                             f"the gate over {split}")
    return W, regs, split


def _moe_partial(S, cfg, xs, routes, W, regs, split):
    """{p: the position's part of the MoE FFN's y (T, its d slice)} from
    tokens xs {p: (T, d)} routed by ``routes``: its experts' buffer (the
    experts of its region), the gate and up products over its d slice
    (their partials all-reduced over the axes splitting d, in float32,
    cast once), the down product over its d_ff slice in cfg.dtype (the
    reference's einsum's), combined in the reference's order. The part
    is float32 where the experts or d_ff are split (a partial for the
    caller to sum over ``split``), else cfg.dtype."""
    dt = cfg.dtype
    e_ax, d_ax, f_ax = split
    partial = bool(e_ax or f_ax)
    hs, us = {}, {}
    for p in S.run:
        (e0, e1), (d0, d1), _ = regs(p)
        buf = MOE.scatter(xs[p], routes[p], e0, e1)[..., d0:d1]
        wg, wu = W["moe_w_gate"][p], W["moe_w_up"][p]
        if d_ax:
            buf = buf.to(torch.float32)
            wg, wu = wg.to(torch.float32), wu.to(torch.float32)
        hs[p], us[p] = torch.bmm(buf, wg), torch.bmm(buf, wu)
        del buf
    if d_ax:
        tag = ",".join(d_ax)
        hs = C.all_reduce(S, hs, d_ax, dtype=dt, what="moe-gate@" + tag)
        us = C.all_reduce(S, us, d_ax, dtype=dt, what="moe-up@" + tag)
    ys = {}
    for p in S.run:
        (e0, e1), _, _ = regs(p)
        out = torch.bmm(silu(hs.pop(p)) * us.pop(p), W["moe_w_down"][p])
        ys[p] = MOE.combine(out, routes[p], xs[p].shape[0],
                            torch.float32 if partial else dt, e0, e1)
    return ys


# ----------------------------------------------------------------------
# train and prefill: batch rows x sequence slices
# ----------------------------------------------------------------------
class _Split:
    """The train / prefill split of a (B, S) batch over the mesh."""

    def __init__(self, cfg, mesh, toks: sh.ShardedTensor):
        self.cfg, self.mesh = cfg, mesh
        self.B, self.S = toks.shape
        self.rows_axes = _axes(toks.sharding.spec[0])
        if len(toks.sharding.spec) > 1 and toks.sharding.spec[1]:
            raise ValueError("the tokens' sequence axis is placed; the "
                             "partitioned step cuts it itself")
        missing = set(_data_axes(mesh)) - set(self.rows_axes)
        if missing:
            raise ValueError(f"a batch of {self.B} does not split over the "
                             f"data axes {sorted(missing)}")
        self.model_axes = _model_axes(mesh)
        regs = _regions(toks.sharding, toks.shape)
        self.rows = {p: r[0] for p, r in regs.items()}
        self.cols = {}
        for p in regs:
            j, m = C.group_index(mesh, p, self.model_axes)
            self.cols[p] = sh._bounds(self.S, m, j)

    def nrows(self, p) -> int:
        lo, hi = self.rows[p]
        return hi - lo

    def positions(self, p):
        lo, hi = self.cols[p]
        return torch.arange(lo, hi, dtype=torch.int32,
                            device=C._devices(self.mesh)[p])[None].expand(
            self.nrows(p), hi - lo)

    def kv(self, S, parts, what):
        """{p: the group's whole K (or V) (rows, S, K, dh)} from each
        position's slice: all-gathered over the model axis."""
        kh, dh = self.cfg.n_kv_heads, self.cfg.d_head

        def region(q):
            return ((0, self.nrows(q)), self.cols[q], (0, kh), (0, dh))
        return C.all_gather(S, parts, self.model_axes, region,
                            lambda p: (self.nrows(p), self.S, kh, dh),
                            what=what)

    def attend(self, p, q, k, v, is_global: bool):
        """The position's queries against its group's whole K / V, as the
        unpartitioned step attends over the whole sequence."""
        cfg = self.cfg
        lo, hi = self.cols[p]
        if T._use_flash(cfg, self.S):
            return flash_attention(q, T._expand_kv(cfg, k),
                                   T._expand_kv(cfg, v), float(is_global),
                                   cfg.window, cfg.attn_chunk, q_offset=lo)
        dev = q.device
        q_pos = torch.arange(lo, hi, dtype=torch.int32, device=dev)
        k_pos = torch.arange(self.S, dtype=torch.int32, device=dev)
        return T.dense_attention(cfg, q, k, v, q_pos, k_pos, is_global)

    def region(self, q):
        """Position q's (rows, sequence slice, d) of its group's whole."""
        return ((0, self.nrows(q)), self.cols[q], (0, self.cfg.d_model))

    def moe(self, S, W, experts, hs):
        """The MoE FFN of a layer at every running position, from its
        ``rms_norm(x, ln2)`` slice ``hs`` {p: (rows, slice, d)} (see the
        module docstring): ({p: y (rows, slice, d) in cfg.dtype}, {p:
        aux / M})."""
        cfg, d = self.cfg, self.cfg.d_model
        regs, split = experts
        if split[1]:
            raise ValueError(f"the expert weights split d over {split[1]}; "
                             "the group step takes the experts or d_ff "
                             "split over the model axis")
        toks = C.all_gather(S, hs, self.model_axes, self.region,
                            lambda p: (self.nrows(p), self.S, d),
                            what="moe-tokens@model")
        xs, routes, aux = {}, {}, {}
        for p in S.run:
            m = C.group_index(self.mesh, p, self.model_axes)[1]
            xs[p] = toks.pop(p).reshape(-1, d)
            routes[p] = MOE.dispatch(xs[p], W["router"][p], cfg.moe_top_k,
                                     cfg.capacity_factor)
            aux[p] = routes[p].aux() / m
        parts = _moe_partial(S, cfg, xs, routes, W, regs, split)
        del xs, routes
        parts = {p: y.view(self.nrows(p), self.S, d)
                 for p, y in parts.items()}
        if split[0] or split[2]:
            return C.reduce_scatter(S, parts, self.model_axes, self.region,
                                    dtype=cfg.dtype,
                                    what="moe-y@model"), aux
        return {p: y[:, slice(*self.cols[p])] for p, y in parts.items()}, aux

    def block(self, S, W, xs, is_global, cache=None, l=None, experts=None):
        """One layer at every running position: {p: x} -> ({p: x}, {p:
        the layer's aux share}, empty for a dense config); K / V slices
        written into ``cache`` {"k", "v": {p: piece}} at layer ``l`` when
        given. ``experts`` is :func:`_gather_layer`'s expert layout."""
        cfg = self.cfg
        lps = {p: {n: W[n][p] for n in W} for p in S.run}
        qkv = {}
        for p in S.run:
            h = rms_norm(xs[p], lps[p]["ln1"])
            qkv[p] = T._project_qkv(cfg, lps[p], h, self.positions(p))
        ks = self.kv(S, {p: qkv[p][1] for p in S.run}, "k@model")
        vs = self.kv(S, {p: qkv[p][2] for p in S.run}, "v@model")
        out, hs = {}, {}
        for p in S.run:
            q, k, v = qkv.pop(p)
            if cache is not None:
                cache["k"][p][l] = k
                cache["v"][p][l] = v
            o = self.attend(p, q, ks.pop(p), vs.pop(p), is_global)
            x = xs[p] + T._out_proj(cfg, lps[p], o)
            del q, k, v, o
            if cfg.is_moe:
                out[p], hs[p] = x, rms_norm(x, lps[p]["ln2"])
                continue
            y, _ = T._ffn(cfg, lps[p], rms_norm(x, lps[p]["ln2"]))
            out[p] = x + y
        if not cfg.is_moe:
            return out, {}
        ys, aux = self.moe(S, W, experts, hs)
        return {p: out[p] + ys.pop(p) for p in S.run}, aux


def _gather_layer(cfg, S, leaves, parts, names, l):
    """({name: {p: layer l of leaf ``blocks/name`` on p's device}}, the
    expert layout or None): each leaf whole in cfg.dtype (the norms and
    the router in float32); the expert weights gathered over every axis
    but the model axis (:func:`_expert_weights`)."""
    W = {n: _whole(S, leaves["blocks/" + n], parts["blocks/" + n], l,
                   None if n in NORMS or n == "router" else cfg.dtype, n)
         for n in names if n not in EXPERTS}
    if not cfg.is_moe:
        return W, None
    keep = _model_axes(S.mesh)
    ew, regs, split = _expert_weights(
        cfg, S, leaves, parts, l,
        tuple(a for a in S.mesh.axis_names if a not in keep))
    W.update(ew)
    return W, (regs, split)


def _chunks(lo: int, hi: int, c: int) -> list:
    """[lo, hi) cut at the multiples of c."""
    out, a = [], lo
    while a < hi:
        b = min(hi, (a // c + 1) * c)
        out.append((a, b))
        a = b
    return out


def _spmd(mesh, leaves, batch_st, key):
    fake = is_fake(next(iter(batch_st.pieces.values())))

    def full_key(p):
        return key(p) + tuple(tuple(st.pieces[p].shape)
                              for st in leaves.values())
    return C.spmd(mesh, full_key, fake)


def value_and_grad(cfg, params, tokens, targets):
    """(the loss (on the mesh's first position's device), {tree path:
    {position: the gradient of that position's piece}}) of ``lm_loss``
    over placed parameters (:func:`place_params`) and (B, S) ids, one
    program a position (see the module docstring). The gradients are
    float32, for the positions that ran."""
    mesh = _mesh()
    leaves = place_params(params, mesh)
    toks = _placed(tokens, ("batch", "seq"), mesh)
    tgts = _placed(targets, ("batch", "seq"), mesh)
    sp = _Split(cfg, mesh, toks)
    B, S_len = sp.B, sp.S
    C_loss = T.loss_chunk_of(cfg, S_len)
    cuts = {p: _chunks(*sp.cols[p], C_loss) for p in sp.cols}
    S = _spmd(mesh, leaves, toks, lambda p: (
        sp.nrows(p), tuple(b - a for a, b in cuts[p])))
    req = {path: {p: st.pieces[p].detach().requires_grad_()
                  for p in S.run} for path, st in leaves.items()}
    names = _block_names(leaves)
    is_global = cfg.layer_is_global()
    remat = cfg.remat
    with torch.enable_grad():
        emb = _whole(S, leaves["embed"], req["embed"], None, cfg.dtype,
                     "embed")
        xs = {}
        for p in S.run:
            lo, hi = sp.cols[p]
            ids = toks.pieces[p][:, lo:hi]
            xs[p] = _Lookup.apply(emb[p], ids.reshape(-1)).view(
                sp.nrows(p), hi - lo, cfg.d_model)

        aux = {p: 0.0 for p in S.run}
        for l in range(cfg.n_layers):
            def layer(*xt, l=l):
                W, experts = _gather_layer(cfg, S, leaves, req, names, l)
                out, a = sp.block(S, W, dict(zip(S.run, xt)),
                                  bool(is_global[l]), experts=experts)
                return tuple(out[p] for p in S.run) + \
                    tuple(a[p] for p in a)
            xt = tuple(xs[p] for p in S.run)
            if remat:
                # recompute every position's whole layer (early stop
                # would skip the last position's trailing ops only); the
                # tensors are closed over, not passed (see the loss)
                with set_checkpoint_early_stop(False):
                    xt = checkpoint(functools.partial(layer, *xt),
                                    use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                xt = layer(*xt)
            n = len(S.run)
            xs = dict(zip(S.run, xt[:n]))
            for p, a in zip(S.run, xt[n:]):
                aux[p] = aux[p] + a
        ln_f = _whole(S, leaves["ln_f"], req["ln_f"], None, None, "ln_f")
        tots = {}
        for p in S.run:
            x = rms_norm(xs.pop(p), ln_f[p])
            lo = sp.cols[p][0]
            tgt = tgts.pieces[p]
            tot = torch.zeros((), dtype=torch.float32, device=S.dev(p))
            for a, b in cuts[p]:
                tot = tot + _chunk_nll_sliced(x[:, a - lo:b - lo],
                                              tgt[:, a:b], emb[p],
                                              VOCAB_SLICE)
            tots[p] = torch.stack([tot, aux[p]]) if cfg.is_moe else tot
        home = S.run[0]
        total = C.all_reduce(S, tots, mesh.axis_names, what="loss")[home]
        if cfg.is_moe:
            # the positions' aux shares sum to the groups' aux; the loss
            # takes 0.01 x their mean, summed over the layers
            G = math.prod(mesh.shape[a] for a in _data_axes(mesh))
            loss = total[0] / (B * S_len) + 0.01 * (total[1] / G)
        else:
            loss = total / (B * S_len)
    flat = [(path, p) for path in req for p in S.run]
    grads = torch.autograd.grad(loss, [req[path][p] for path, p in flat],
                                allow_unused=True)
    out = {path: {} for path in req}
    for (path, p), g in zip(flat, grads):
        out[path][p] = torch.zeros_like(req[path][p]) if g is None else g
    return loss.detach(), out


@torch.no_grad()
def prefill(cfg, params, tokens):
    """(last-token logits (B, V) float32, placed over the batch's axes,
    a cache {"k", "v": (L, B, S, K, dh) placed (batch, kv_seq over
    "model"), "len": S}) of ``prefill`` over placed parameters, one
    program a position."""
    mesh = _mesh()
    leaves = place_params(params, mesh)
    toks = _placed(tokens, ("batch", "seq"), mesh)
    sp = _Split(cfg, mesh, toks)
    last = {p: sp.cols[p][1] == sp.S for p in sp.cols}
    S = _spmd(mesh, leaves, toks, lambda p: (
        sp.nrows(p), sp.cols[p][1] - sp.cols[p][0], last[p]))
    pieces = {path: {p: st.pieces[p] for p in S.run}
              for path, st in leaves.items()}
    names = _block_names(leaves)
    is_global = cfg.layer_is_global()
    L, kh, dh, V = cfg.n_layers, cfg.n_kv_heads, cfg.d_head, cfg.vocab
    emb = _whole(S, leaves["embed"], pieces["embed"], None, cfg.dtype,
                 "embed")
    cache = {"k": {}, "v": {}}
    xs = {}
    for p in S.run:
        lo, hi = sp.cols[p]
        ids = toks.pieces[p][:, lo:hi]
        xs[p] = emb[p].index_select(0, ids.reshape(-1)).view(
            sp.nrows(p), hi - lo, cfg.d_model)
        shape = (L, sp.nrows(p), hi - lo, kh, dh)
        for n in ("k", "v"):
            cache[n][p] = torch.empty(shape, dtype=cfg.dtype,
                                      device=S.dev(p))
    for l in range(L):
        W, experts = _gather_layer(cfg, S, leaves, pieces, names, l)
        xs, _ = sp.block(S, W, xs, bool(is_global[l]), cache, l, experts)
        del W
    ln_f = _whole(S, leaves["ln_f"], pieces["ln_f"], None, None, "ln_f")
    parts = {}
    for p in S.run:
        n = sp.nrows(p)
        if last[p]:
            x = rms_norm(xs.pop(p), ln_f[p])
            parts[p] = (x[:, -1] @ emb[p].T).to(torch.float32)[:, None]
        else:
            parts[p] = torch.empty((n, 0, V), dtype=torch.float32,
                                   device=S.dev(p))
    # the last slice's logits to its group's other positions
    logits = C.all_gather(
        S, parts, sp.model_axes,
        lambda q: ((0, sp.nrows(q)), (0, int(last[q])), (0, V)),
        lambda p: (sp.nrows(p), 1, V), what="logits@model")
    rows = toks.sharding.spec[0]
    lspec = sh.NamedSharding(mesh, (rows, None))
    cspec = sh.NamedSharding(mesh, (None, rows, sp.model_axes or None,
                                    None, None))
    cshape = (L, sp.B, sp.S, kh, dh)
    return (sh.ShardedTensor(lspec, (sp.B, V),
                             {p: t[:, 0] for p, t in logits.items()}),
            {"k": sh.ShardedTensor(cspec, cshape, cache["k"]),
             "v": sh.ShardedTensor(cspec, cshape, cache["v"]),
             "len": sp.S})


# ----------------------------------------------------------------------
# decode: weights stay on their pieces, activations move
# ----------------------------------------------------------------------
class _Decode:
    """A decode step's layout: the rows and slots each position holds,
    and the tensor-parallel products over the weights' pieces."""

    def __init__(self, cfg, mesh, leaves, kst):
        self.cfg, self.mesh, self.leaves = cfg, mesh, leaves
        self.S = None               # the positions that run: set by the caller
        spec = tuple(kst.sharding.spec) + (None,) * 5
        if any(spec[i] for i in (0, 3, 4)):
            raise ValueError(f"the cache is placed {kst.sharding.spec}; "
                             "decode splits its batch and slots only")
        self.rows_axes, self.slot_axes = _axes(spec[1]), _axes(spec[2])
        regs = _regions(kst.sharding, kst.shape)
        self.rows = {p: r[1] for p, r in regs.items()}
        self.slots = {p: r[2] for p, r in regs.items()}

    def nrows(self, p) -> int:
        lo, hi = self.rows[p]
        return hi - lo

    def tp(self, name, l, hs, cdims, hreg=None, keep=False, local=None):
        """{p: h @ W} of leaf ``name`` (layer ``l``) contracted over its
        dims ``cdims`` with ``hs`` {p: (rows, *cdims)} (whole along them,
        or at ``hreg[p]``), in ``cfg.dtype``. W is gathered over the
        axes that split the rows only; the partials of a contraction
        split over other axes are all-reduced, an output split over
        other axes is all-gathered, unless ``keep``: then ({p: the
        output's piece}, {p: its region over the output dims}).
        ``local(h, W, region)`` replaces the product."""
        S, dt = self.S, self.cfg.dtype
        st = self.leaves[name]
        shape = tuple(st.shape[0 if l is None else 1:])
        W, eff, left = _gather_over(S, st, st.pieces, l, self.rows_axes,
                                    dt, name)
        odims = [i for i in range(len(shape)) if i not in cdims]
        red = tuple(a for i in cdims for a in left[i])
        outs, oreg = {}, {}
        for p in S.run:
            e, w = eff(p), W.pop(p)
            if local is not None:
                y = local(hs[p], w, e)
            else:
                base = hreg[p] if hreg is not None else \
                    tuple((0, shape[i]) for i in cdims)
                h = hs[p][(slice(None),) + tuple(
                    slice(e[i][0] - b[0], e[i][1] - b[0])
                    for i, b in zip(cdims, base))]
                n = h.shape[0]
                wm = w.permute(*cdims, *odims).reshape(
                    math.prod(w.shape[i] for i in cdims), -1)
                hm = h.reshape(n, -1)
                y = hm.float() @ wm.float() if red else hm @ wm
                y = y.view(n, *(w.shape[i] for i in odims))
            outs[p] = y
            oreg[p] = tuple(e[i] for i in odims)
        if red:
            outs = C.all_reduce(S, outs, red, dtype=dt,
                                what=f"{name}@{','.join(red)}")
        if keep:
            return outs, oreg
        gat = tuple(a for i in odims for a in left[i])
        if not gat:
            return outs
        oshape = tuple(shape[i] for i in odims)

        def oregion(q):
            e = eff(q)
            return ((0, self.nrows(q)),) + tuple(e[i] for i in odims)
        return C.all_gather(S, outs, gat, oregion,
                            lambda p: (self.nrows(p),) + oshape,
                            what=f"{name}.out@{','.join(gat)}")

    def moe(self, l, hs):
        """{p: the MoE FFN's y (rows, d) in cfg.dtype} of layer ``l`` from
        ``hs`` {p: (rows, d)}: each position routes its own rows (the
        router gathered whole, float32); the expert weights gathered over
        the rows' axes only; the partial y all-reduced over the axes that
        split the experts or d_ff, then all-gathered over those that
        split d."""
        S, cfg = self.S, self.cfg
        rt = self.leaves["blocks/router"]
        router, _, _ = _gather_over(
            S, rt, rt.pieces, l, {a for e in rt.sharding.spec
                                  for a in _axes(e)}, None, "blocks/router")
        routes = {p: MOE.dispatch(hs[p], router.pop(p), cfg.moe_top_k,
                                  cfg.capacity_factor) for p in S.run}
        W, regs, split = _expert_weights(
            cfg, S, self.leaves, {"blocks/" + n: self.leaves[
                "blocks/" + n].pieces for n in EXPERTS}, l, self.rows_axes)
        ys = _moe_partial(S, cfg, hs, routes, W, regs, split)
        del W, routes
        red = split[0] + split[2]
        if red:
            ys = C.all_reduce(S, ys, red, dtype=cfg.dtype,
                              what=f"moe-y@{','.join(red)}")
        if not split[1]:
            return ys
        d = cfg.d_model
        return C.all_gather(S, ys, split[1],
                            lambda q: ((0, self.nrows(q)), regs(q)[1]),
                            lambda p: (self.nrows(p), d),
                            what=f"moe-y.out@{','.join(split[1])}")


def _lookup_local(w, e, ids):
    """The rows of ``ids`` in the vocab slice ``e[0]`` of the embedding
    piece ``w``, zero for an id outside it."""
    v0, v1 = e[0]
    i = ids.to(w.device)
    hit = (i >= v0) & (i < v1)
    rows = w.index_select(0, torch.clamp(i - v0, 0, v1 - v0 - 1))
    return torch.where(hit[:, None], rows, torch.zeros_like(rows))


@torch.no_grad()
def decode_step(cfg, params, cache: dict, token):
    """(logits (B, V) float32 placed (batch, vocab), the cache with len +
    1) of one ``decode_step`` over placed parameters and a placed cache
    {"k", "v": (L, B, S, K, dh) ShardedTensors, "len"}: the new keys and
    values are written into the owning pieces in place. A full cache
    raises ValueError."""
    mesh = _mesh()
    leaves = place_params(params, mesh)
    kst, vst = cache["k"], cache["v"]
    Smax = kst.shape[2]
    n_len = cache["len"]
    if isinstance(n_len, sh.ShardedTensor):
        n_len = next(iter(n_len.pieces.values()))
    if is_fake(n_len):
        worst_case("decode_step: the cache's len taken as S - 1")
        host_read("_local_scalar_dense")
        pos = Smax - 1
    else:
        pos = int(n_len)
    if pos >= Smax:
        raise ValueError(
            f"the cache is full: len {pos} of {Smax} slots; pad it before "
            f"decoding (the reference clamps its write to slot {Smax - 1})")
    missing = set(_data_axes(mesh)) - set(_axes(kst.sharding.spec[1])) \
        - set(_axes(kst.sharding.spec[2]))
    if missing:
        raise ValueError(f"the cache's batch and slots do not split over "
                         f"the data axes {sorted(missing)}")
    layout = _Decode(cfg, mesh, leaves, kst)
    if cfg.is_moe:
        # a position's rows must be its data group's (all the rows where
        # the groups do not divide the batch), as the reference routes
        G = math.prod(mesh.shape[a] for a in _data_axes(mesh))
        want = _data_axes(mesh) if G > 1 and kst.shape[1] % G == 0 else ()
        if tuple(a for a in layout.rows_axes if mesh.shape[a] > 1) != want:
            raise ValueError(
                f"{cfg.name}: a batch of {kst.shape[1]} placed over "
                f"{layout.rows_axes}; the MoE decode routes the rows of "
                f"the data groups {want or 'as one'} on their own")
    owns = {p: layout.slots[p][0] <= pos < layout.slots[p][1]
            for p in layout.slots}
    S = _spmd(mesh, leaves, kst, lambda p: (
        layout.nrows(p), layout.slots[p][1] - layout.slots[p][0], owns[p]))
    layout.S = S
    tok = _placed(token, ("batch",), mesh)
    treg = _regions(tok.sharding, tok.shape)
    dt, H, K, dh = cfg.dtype, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    reps = H // K
    ids = {}
    for p in S.run:
        (t0, _), = treg[p]
        r0, r1 = layout.rows[p]
        ids[p] = tok.pieces[p][r0 - t0:r1 - t0].long()

    # the embedding: each position looks its rows up in its vocab slice
    xs = layout.tp("embed", None, ids, (0,),
                   local=lambda h, w, e: _lookup_local(w, e, h))
    is_global = cfg.layer_is_global()

    def W(n):
        return "blocks/" + n
    for l in range(cfg.n_layers):
        hs = {p: rms_norm(xs[p], leaves[W("ln1")].pieces[p][l])
              for p in S.run}
        q = layout.tp(W("wq"), l, hs, (0,))
        k = layout.tp(W("wk"), l, hs, (0,))
        v = layout.tp(W("wv"), l, hs, (0,))
        o = {}
        for p in S.run:
            n = layout.nrows(p)
            dev = S.dev(p)
            qp, kp, vp = (q.pop(p)[:, None], k.pop(p)[:, None],
                          v.pop(p)[:, None])
            if cfg.qk_norm:
                qp = rms_norm(qp, leaves[W("qnorm")].pieces[p][l])
                kp = rms_norm(kp, leaves[W("knorm")].pieces[p][l])
            at = torch.full((n, 1), pos, dtype=torch.int32, device=dev)
            qp = rope(qp, at, cfg.rope_theta)
            kp = rope(kp, at, cfg.rope_theta)
            s0, s1 = layout.slots[p]
            ck, cv = kst.pieces[p][l], vst.pieces[p][l]
            if owns[p]:
                ck[:, pos - s0] = kp[:, 0]
                cv[:, pos - s0] = vp[:, 0]
            k_pos = torch.arange(s0, s1, device=dev)
            valid = k_pos <= pos
            if cfg.window > 0 and not is_global[l]:
                valid = valid & (k_pos > pos - cfg.window)
            qh = qp[:, 0]
            sc = torch.cat([torch.bmm(qh[:, j * reps:(j + 1) * reps],
                                      ck[:, :, j].transpose(1, 2))
                            for j in range(K)], dim=1).to(torch.float32)
            sc = sc / math.sqrt(dh)
            sc = torch.where(valid[None, None], sc, T.NEG)  # (n, H, T)
            m = sc.amax(-1)
            pr = torch.exp(sc - m[..., None])
            lsum = pr.sum(-1)
            ov = torch.cat([torch.bmm(pr[:, j * reps:(j + 1) * reps],
                                      cv[:, :, j].to(torch.float32))
                            for j in range(K)], dim=1)       # (n, H, dh)
            o[p] = torch.cat([m[..., None], lsum[..., None], ov], -1)
        o = _merge(layout, o, dt)
        y = layout.tp(W("wo"), l, o, (0, 1))
        for p in S.run:
            xs[p] = xs[p] + y.pop(p)
        hs = {p: rms_norm(xs[p], leaves[W("ln2")].pieces[p][l])
              for p in S.run}
        if cfg.is_moe:
            y = layout.moe(l, hs)
            for p in S.run:
                xs[p] = xs[p] + y.pop(p)
            continue
        g, greg = layout.tp(W("w_gate"), l, hs, (0,), keep=True)
        u, _ = layout.tp(W("w_up"), l, hs, (0,), keep=True)
        gu = {p: silu(g.pop(p)) * u.pop(p) for p in S.run}
        y = layout.tp(W("w_down"), l, gu, (0,), hreg=greg)
        for p in S.run:
            xs[p] = xs[p] + y.pop(p)
    hs = {p: rms_norm(xs[p], leaves["ln_f"].pieces[p]) for p in S.run}
    logits, _ = layout.tp("embed", None, hs, (1,), keep=True)
    lspec = sh.NamedSharding(mesh, (kst.sharding.spec[1] or None,
                                    leaves["embed"].sharding.spec[0] or None))
    B = kst.shape[1]
    return (sh.ShardedTensor(lspec, (B, cfg.vocab),
                             {p: t.to(torch.float32)
                              for p, t in logits.items()}),
            {"k": kst, "v": vst, "len": pos + 1})


def _merge(layout, parts, dt):
    """{p: (rows, H, dh) in ``dt``}: the slot positions' partial
    softmaxes {p: (rows, H, dh + 2) = max, sum, weighted V} merged by
    log-sum-exp: the maxima all-reduced (max) over the slot axes, each
    partial rescaled to the common max, the sums and weighted V
    all-reduced (sum, in position order, in float32)."""
    S, axes = layout.S, layout.slot_axes
    if not axes:
        return {p: (t[..., 2:] / t[..., 1:2]).to(dt)
                for p, t in parts.items()}
    tag = ",".join(axes)
    top = C.all_reduce(S, {p: t[..., 0] for p, t in parts.items()}, axes,
                       op="max", what="softmax-max@" + tag)
    scaled = {p: t[..., 1:] * torch.exp(t[..., :1] - top[p][..., None])
              for p, t in parts.items()}
    tot = C.all_reduce(S, scaled, axes, what="softmax-sum@" + tag)
    return {p: (t[..., 1:] / t[..., :1]).to(dt) for p, t in tot.items()}
