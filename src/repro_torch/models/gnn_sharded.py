"""The GNNs on a mesh: the node-sharded GCN of the shardmap cell, and
the base GNN step of all four kinds on the placed pieces of its
arguments.

**The node-sharded GCN** (port of ``repro/models/gnn_sharded.py``):
dst-partitioned edges, one all-gather of the hidden state a layer. The
nodes split into NS contiguous shards over the active mesh's node axes
(``_node_axes``: "pod", "data" and "model", those of size > 1, in
row-major order). Edges are pre-partitioned by the shard of their
destination ("block-aligned CSR"): row s of the ``blk_*`` arrays (NS,
E_max) holds exactly the edges whose destination lies in shard s, as
global source ids, destination offsets within the shard and weights,
padded with weight 0. Each layer, on each shard:

    h      = h_local @ W + b
    h_full = all_gather(h)                     <- the only exchange
    msgs   = h_full[src_local] * w_local
    h_next = segment_sum(msgs, dst_local, n_local) + h * w_self

The port is single-controller: shard s runs on its mesh position's
device from the calling thread, and the all-gather concatenates the
shards' h once for each distinct device (four shards on ``cuda:0`` make
one gather). The weights are read whole, as the reference's replicated
``P()`` in_specs read them. The loss is the sum of the shards' masked
NLL, in shard order, over the sum of their masks; its gradient flows
through autograd (the gather's backward splits the gradient of h_full
back to the shards, the reference's reduce-scatter).

**The base GNN step** (:func:`value_and_grad`, :func:`loss_sharded`):
by hand, what GSPMD derives for the reference's ``gnn.loss_fn`` on the
base cell's placements (``launch/specs.py``): node rows (feats,
node_mask, labels or targets) and edge slices (edge_src / dst / mask,
graphcast's g2m_* and m2g_*, by edge index, not by destination) over
the node axes, the weights replicated. Each mesh position runs one
program, position by position in row-major order, and keeps its own
node rows between layers. A message exchange (a layer of gcn, gat or
pna, each of graphcast's 2 + n_layers) is, on each position p:

  1. node work on p's rows: ``h @ W``, GAT's scores, PNA's
     ``relu(h @ w_pre)``, graphcast's encoders (the grid test
     ``lo + arange(n_l) < n_grid``, n_grid read as a tensor);
  2. ``collectives.gather_at``: the node table that p's edges read,
     whole (n, F) on p's device;
  3. p's own edges: index, message, and segment-sum into a whole (n, F)
     partial;
  4. ``collectives.ScatterSum``: the partials reduce-scattered back to
     the rows, one position's partial at a time.

Steps 2-3 run in a checkpoint a position, so the (n, F) table and the
(m_l, .) edge tensors live only inside one position's forward or
backward of one exchange, and a mesh that repeats one device holds one
position's whole tensors at a time. The degrees (GCN's deg and deg_s,
PNA's deg) are counted the same way, each position its own edges,
reduce-scattered, and gathered where an edge reads them; PNA's
mean_log_deg is the mean of its (n, 1) log-degree column gathered whole
(over the padded n, as the reference takes it, with the unpartitioned
step's bits: its gradient is ill-conditioned in that scalar). The maxima
across positions: PNA's max and min aggregators go through
``reduce_scatter(op="max", counts=)``, whose backward splits a gradient
equally among every entry tied at the maximum on every position, as
one ``segment_max`` over the whole segment does (:class:`_TiedMax` is
the position's local maximum, which passes its share on undivided);
GAT's softmax detaches its per-destination maximum (the softmax does not
depend on it), reduces it with the undifferentiated maximum and forms
each destination's numerator and denominator as partial sums, dividing
once on its rows. The loss sums each position's masked NLL (masked MSE
for graphcast) and its mask count, all-reduced in position order in
float32. A replicated weight's gradient is every position's, all-reduced
over the node axes in row-major order in float32: each copy gets the
same sum. The reference's masking constants (-1e30, 1e30, ``isfinite``)
and the port's zero gradient at PNA's std where var <= 0
(``models/gnn.py``) are kept.

Plain torch ops: the reference's message passing is XLA's, outside any
Pallas kernel. A dry run (fake tensors on distinct devices) runs one
program for each class of positions whose programs have equal shapes
(``collectives.spmd``): with n and m split evenly every position is in
one class. n and every edge count must divide by the node axes' size
(the cells pad them to multiples of 512); an uneven split raises.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.cost import collective, is_fake
from repro_torch.launch import collectives as C
from repro_torch.launch import sharding as sh
from repro_torch.launch.sharding import ShardedTensor, active_mesh
from repro_torch.models.gnn import _pna_std
from repro_torch.models.layers import (leaky_relu, segment_max,
                                       segment_sum)


def _node_axes(mesh):
    return tuple(a for a in ("pod", "data", "model")
                 if a in mesh.shape and mesh.shape[a] > 1)


def gcn_loss_sharded(cfg, params, batch):
    """Full-batch GCN cross-entropy with node-sharded message passing.

    ``params`` a ``gnn.GNNParams`` of a GCN; ``batch`` (NumPy or
    tensors): feats (n, F) with n a multiple of NS, blk_src / blk_dstl
    / blk_w (NS, E_max) dst-partitioned edges, w_self (n,) self-loop
    weights, labels / node_mask (n,), as ``build_sharded_gcn_batch``
    makes them; a leaf may come placed (a ``ShardedTensor`` split over
    the node axes, as ``launch/specs.py``'s shardmap cell places it),
    and each shard then reads its own piece. The all-gather's copies
    are named "all-gather" for the op walk. Needs an active mesh
    (``launch.sharding.use_mesh_rules``); the loss lands on the first
    shard's device."""
    mesh = active_mesh()
    if mesh is None:
        raise ValueError("the sharded GCN needs an active mesh "
                         "(launch.sharding.use_mesh_rules)")
    axes = _node_axes(mesh)
    devs = mesh.axes_devices(axes)
    positions = mesh.axes_positions(axes)
    ns = len(devs)
    b = {}
    for k in ("feats", "blk_src", "blk_dstl", "blk_w", "w_self", "labels",
              "node_mask"):
        x = batch[k]
        if isinstance(x, ShardedTensor) and \
                tuple(x.sharding.spec[0] or ()) != axes:
            raise ValueError(f"batch[{k!r}] is placed as "
                             f"{x.sharding.spec}; the sharded GCN reads "
                             f"pieces split over {axes}")
        b[k] = x if isinstance(x, ShardedTensor) else torch.as_tensor(x)
    n = b["feats"].shape[0]
    if b["blk_src"].shape[0] != ns or n % ns:
        raise ValueError(f"{b['blk_src'].shape[0]} edge blocks and {n} "
                         f"nodes for {ns} node shards")
    n_l = n // ns

    def part(k, s, dev):
        """Shard s's rows of batch[k] (its edge block for blk_*) on
        ``dev``: a placed leaf's own piece there, else cut and copied."""
        x = b[k]
        blk = k.startswith("blk_")
        if isinstance(x, ShardedTensor):
            piece = x.pieces[positions[s]]
            return piece[0] if blk else piece
        return (x[s] if blk else x[s * n_l:(s + 1) * n_l]).to(dev)

    shards = []
    for s, dev in enumerate(devs):
        shards.append({
            "h": part("feats", s, dev),
            "src": part("blk_src", s, dev).long(),
            "dstl": part("blk_dstl", s, dev).long(),
            "w": part("blk_w", s, dev),
            "w_self": part("w_self", s, dev),
            "labels": part("labels", s, dev).long(),
            "mask": part("node_mask", s, dev).to(torch.float32)})
    g = params.gnn
    hs = [sh["h"] for sh in shards]
    for i in range(cfg.n_layers):
        hs = [h @ g.w[i].to(dev) + g.b[i].to(dev)
              for h, dev in zip(hs, devs)]
        full = {}
        with collective("all-gather"):
            for dev in devs:
                if dev not in full:
                    full[dev] = torch.cat([h.to(dev) for h in hs])
        nxt = []
        for h, sh, dev in zip(hs, shards, devs):
            msgs = full[dev].index_select(0, sh["src"]) * sh["w"][:, None]
            h = segment_sum(msgs, sh["dstl"], n_l) + h * sh["w_self"][:, None]
            nxt.append(torch.relu(h) if i < cfg.n_layers - 1 else h)
        del full
        hs = nxt
    home = devs[0]
    tot = cnt = None
    for h, sh in zip(hs, shards):
        logits = h.to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, sh["labels"][:, None])[:, 0]
        nll = ((logz - gold) * sh["mask"]).sum().to(home)
        m = sh["mask"].sum().to(home)
        tot, cnt = (nll, m) if tot is None else (tot + nll, cnt + m)
    return tot / torch.clamp(cnt, min=1.0)


def build_sharded_gcn_batch(g, d_feat: int, n_classes: int, ns: int,
                            e_max: int | None = None, seed: int = 0) -> dict:
    """The reference's host-side layout, bit for bit: nodes padded to a
    multiple of ``ns``, ``gnn_batch``'s arrays padded with zeros, and
    the dst-partitioned edge blocks (NS, e_max), each block's edges in
    the graph's edge order. Vectorised: one stable sort of the edges by
    destination block (a radix sort on 16-bit block ids), where the
    reference appends edge by edge. ``e_max`` below the widest block
    raises."""
    from repro_torch.data import pipeline

    n_pad = -(-g.n // ns) * ns
    bn = n_pad // ns
    base = pipeline.gnn_batch(g, d_feat, n_classes, seed=seed)
    src = np.asarray(g.edge_src, np.int64)
    dst = np.asarray(g.edge_dst, np.int64)
    # float32 counts, exact below 2^24 as the reference's np.add.at
    deg = np.bincount(dst, minlength=n_pad).astype(np.float32)
    deg_s = np.bincount(src, minlength=n_pad).astype(np.float32)
    w_e = 1.0 / np.sqrt((deg_s[src] + 1) * (deg[dst] + 1))
    blk = dst // bn
    counts = np.bincount(blk, minlength=ns)
    width = max(int(counts.max(initial=0)), 1)
    e_max = e_max or width
    if e_max < width:
        raise ValueError(f"e_max {e_max} below the widest block's {width} "
                         "edges")
    key = blk.astype(np.uint16) if ns <= 1 << 16 else blk
    order = np.argsort(key, kind="stable")
    rows = blk[order]
    cols = np.arange(len(order)) - np.repeat(np.cumsum(counts) - counts,
                                             counts)
    blk_src = np.zeros((ns, e_max), np.int32)
    blk_dstl = np.zeros((ns, e_max), np.int32)
    blk_w = np.zeros((ns, e_max), np.float32)
    blk_src[rows, cols] = src[order]
    blk_dstl[rows, cols] = dst[order] - rows * bn
    blk_w[rows, cols] = w_e[order]

    def pad_nodes(x):
        if x.shape[0] == n_pad:
            return x
        pad = [(0, n_pad - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, pad)

    return {
        "feats": pad_nodes(base["feats"]),
        "blk_src": blk_src, "blk_dstl": blk_dstl, "blk_w": blk_w,
        "w_self": 1.0 / (deg + 1.0),
        "labels": pad_nodes(base["labels"]),
        "node_mask": pad_nodes(base["node_mask"]),
    }


# ----------------------------------------------------------------------
# the base GNN step on placed pieces
# ----------------------------------------------------------------------
ROW_LEAVES = ("feats", "sim_feat", "node_mask", "labels", "targets")
EDGE_SETS = {"": ("edge_src", "edge_dst", "edge_mask"),
             "g2m": ("g2m_src", "g2m_dst", "g2m_mask"),
             "m2g": ("m2g_src", "m2g_dst", "m2g_mask")}
F32 = torch.float32


class _SegSum(torch.autograd.Function):
    """(n, ...): the rows of ``data`` added at ``ids`` (node ids in
    range) into new zeros. Its backward reads the gradient's rows at
    ``ids`` and keeps nothing of ``data`` (``index_add``'s own backward
    keeps the whole source for its shape)."""

    @staticmethod
    def forward(ctx, data, ids, n):
        ctx.save_for_backward(ids)
        out = torch.zeros((n,) + tuple(data.shape[1:]), dtype=data.dtype,
                          device=data.device)
        return out.index_add_(0, ids, data)

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        return g.index_select(0, ids), None, None


def _seg_sum(data, ids, n: int):
    return _SegSum.apply(data, ids, n)


class _TiedMax(torch.autograd.Function):
    """(``segment_max(data, ids, n)``, each segment's count of the entries
    equal to its maximum, float32). The backward passes a segment's
    gradient to each entry equal to its maximum undivided: the gradient
    it gets from ``reduce_scatter(op="max", counts=)`` is already the
    segment's gradient over the tied entries of every position."""

    @staticmethod
    def forward(ctx, data, ids, n):
        top = segment_max(data, ids, n)
        hit = data == top.index_select(0, ids)
        ties = _seg_sum(hit.to(F32), ids, n)
        ctx.save_for_backward(hit, ids)
        ctx.mark_non_differentiable(ties)
        return top, ties

    @staticmethod
    def backward(ctx, g, _):
        hit, ids = ctx.saved_tensors
        return torch.where(hit, g.index_select(0, ids), 0.0), None, None


def _remat(fn, args):
    """``fn(*args)``, recomputed in the backward when gradients are on."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(functools.partial(fn, *args), use_reentrant=False,
                      preserve_rng_state=False)


class _Graph:
    """The batch of a partitioned step, read one position at a time: the
    node axes, the rows' and edge slices' pieces, the class shortcut's
    positions (``S``)."""

    def __init__(self, batch, mesh, leaves):
        given = batch["feats"]
        if isinstance(given, ShardedTensor):
            axes = tuple(given.sharding.spec[0] or ()) \
                if given.sharding.spec else ()
        else:
            axes = _node_axes(mesh)
        self.axes = axes
        self.k = math.prod(mesh.shape[a] for a in axes)
        self.st = {}
        for key, x in batch.items():
            if key == "n_grid":
                self.st[key] = x if isinstance(x, ShardedTensor) else \
                    sh.place(torch.as_tensor(x), (), mesh)
                continue
            if not isinstance(x, ShardedTensor):
                x = torch.as_tensor(x)
                self._even(key, x.shape[0])
                x = sh.place(x, (axes,) + (None,) * (x.dim() - 1), mesh)
            spec = tuple(x.sharding.spec) + (None,) * len(x.shape)
            if _eff(mesh, spec[0]) != _eff(mesh, axes) or any(spec[1:]):
                raise ValueError(
                    f"batch[{key!r}] is placed as {x.sharding.spec}; the "
                    f"partitioned GNN step reads rows and edge slices "
                    f"split over {axes} alone")
            self._even(key, x.shape[0])
            self.st[key] = x
        self.n = self.st["feats"].shape[0]
        self.n_l = self.n // self.k
        self.lo = {p: C.group_index(mesh, p, axes)[0] * self.n_l
                   for p in C.positions(mesh)}
        fake = is_fake(next(iter(self.st["feats"].pieces.values())))

        def key(p):
            return tuple(tuple(st.pieces[p].shape)
                         for st in (*self.st.values(), *leaves.values()))
        self.S = C.spmd(mesh, key, fake)
        self._edges = {}

    def _even(self, key, rows):
        if rows % self.k:
            raise ValueError(
                f"batch[{key!r}] has {rows} rows for {self.k} positions "
                f"over {self.axes}: an uneven split (pad to a multiple; "
                f"the cells pad to 512)")

    def region(self, width=None):
        """q -> q's rows (and ``width`` columns) of a node table."""
        n_l, lo = self.n_l, self.lo
        if width is None:
            return lambda q: ((lo[q], lo[q] + n_l),)
        return lambda q: ((lo[q], lo[q] + n_l), (0, width))

    def rows(self, key):
        return {p: self.st[key].pieces[p] for p in self.S.run}

    def edges(self, which=""):
        """({p: src}, {p: dst}, {p: mask}) of p's edge slice: global node
        ids as int64, the mask as float32."""
        if which not in self._edges:
            s, d, m = (self.st[k] for k in EDGE_SETS[which])
            run = self.S.run
            self._edges[which] = ({p: s.pieces[p].long() for p in run},
                                  {p: d.pieces[p].long() for p in run},
                                  {p: m.pieces[p].to(F32) for p in run})
        return self._edges[which]

    def gather(self, xs, p, width, what):
        return C.gather_at(self.S, xs, p, self.axes, self.region(width),
                           (self.n, width), what=what)

    def exchange(self, xs, width, out_width, work, dst, what):
        """{q: the sum at q's rows of every position's messages}: on each
        position p, ``work(p, the gathered (n, width) table of xs)`` ->
        p's edge messages (m_l, out_width), added at ``dst[p]``."""
        S = self.S
        rs = C.ScatterSum(S, self.axes, self.region(out_width), what=what)
        pieces = [xs[q] for q in S.run]
        for p in S.run:
            def fn(*pieces, p=p):
                full = self.gather(dict(zip(S.run, pieces)), p, width, what)
                return work(p, full)
            msg = _remat(fn, pieces)
            rs.add(p, _seg_sum(msg, dst[p], self.n))
            del msg
        return rs.result()


def _eff(mesh, axes) -> tuple:
    """``axes`` without the mesh's size-1 axes."""
    return tuple(a for a in (axes or ()) if mesh.shape[a] > 1)


def _weights(leaves, req):
    """name -> {p: the position's copy of weight ``gnn/name``}, ``i``
    picking a list's item; every weight must be replicated."""
    for path, st in leaves.items():
        if any(st.sharding.spec):
            raise ValueError(f"{path} is placed as {st.sharding.spec}; the "
                             "partitioned GNN step reads replicated weights")

    def w(name, i=None):
        path = f"gnn/{name}" if i is None else f"gnn/{name}/{i}"
        return req[path]
    return w


def _gcn(cfg, G, w, h):
    S, n = G.S, G.n
    es, ed, em = G.edges()
    deg = C.ScatterSum(S, G.axes, G.region(2), what="gcn/deg")
    for p in S.run:
        deg.add(p, torch.stack([_seg_sum(em[p], ed[p], n),
                                _seg_sum(em[p], es[p], n)], 1))
    deg = {p: d + 1.0 for p, d in deg.result().items()}
    inv = {p: torch.rsqrt(d) for p, d in deg.items()}
    w_e = {}
    for p in S.run:
        r = G.gather(inv, p, 2, "gcn/deg")
        w_e[p] = em[p] * r[:, 1].index_select(0, es[p]) \
            * r[:, 0].index_select(0, ed[p])
    w_self = {p: 1.0 / d[:, 0] for p, d in deg.items()}
    for i in range(cfg.n_layers):
        h = {p: h[p] @ w("w", i)[p] + w("b", i)[p] for p in S.run}
        width = h[S.run[0]].shape[1]
        agg = G.exchange(
            h, width, width,
            lambda p, full: full.index_select(0, es[p]) * w_e[p][:, None],
            ed, f"gcn/{i}")
        h = {p: agg[p] + h[p] * w_self[p][:, None] for p in S.run}
        if i < cfg.n_layers - 1:
            h = {p: torch.relu(x) for p, x in h.items()}
    return h


def _gat(cfg, G, w, h):
    S, n, L = G.S, G.n, cfg.n_layers
    es, ed, em = G.edges()
    live = {p: m[:, None] > 0 for p, m in em.items()}

    def scores(p, small, H):
        e = leaky_relu(small[:, :H].index_select(0, es[p])
                       + small[:, H:2 * H].index_select(0, ed[p]))
        return torch.where(live[p], e, -1e30)

    for i in range(L):
        H = cfg.n_heads if i < L - 1 else 1
        dh = cfg.d_hidden if i < L - 1 else cfg.out_dim
        z = {p: h[p] @ w("w", i)[p] for p in S.run}
        sc = {p: torch.cat([(z[p].view(-1, H, dh)
                             * w("a_src", i)[p][None]).sum(-1),
                            (z[p].view(-1, H, dh)
                             * w("a_dst", i)[p][None]).sum(-1)], -1)
              for p in S.run}
        # the softmax's shift, each destination's largest score over every
        # position's edges: detached, as the softmax does not depend on it
        with torch.no_grad():
            tops = {}
            for p in S.run:
                table = G.gather(sc, p, 2 * H, f"gat/{i}/scores")
                tops[p] = segment_max(scores(p, table, H), ed[p], n)
                del table
            top = C.reduce_scatter(S, tops, G.axes, G.region(H),
                                   dtype=tops[S.run[0]].dtype,
                                   what=f"gat/{i}/max", op="max")
            del tops
        small = {p: torch.cat([sc[p], top[p]], -1) for p in S.run}

        def work(p, full, H=H, dh=dh, small=small, i=i):
            s = G.gather(small, p, 3 * H, f"gat/{i}/scores")
            ex = torch.exp(scores(p, s, H)
                           - s[:, 2 * H:].index_select(0, ed[p]))
            msgs = full.index_select(0, es[p]).view(-1, H, dh) \
                * (ex * em[p][:, None])[:, :, None]
            return torch.cat([msgs.reshape(-1, H * dh), ex], -1)
        agg = G.exchange(z, H * dh, H * dh + H, work, ed, f"gat/{i}")
        # alpha = ex / den a destination, summed: num / den on the rows
        h = {p: (a[:, :H * dh].view(-1, H, dh)
                 / torch.clamp(a[:, H * dh:], min=1e-20)[:, :, None]
                 ).reshape(-1, H * dh) for p, a in agg.items()}
        if i < L - 1:
            h = {p: torch.nn.functional.elu(x) for p, x in h.items()}
    return h


def _pna(cfg, G, w, h):
    S, n = G.S, G.n
    es, ed, em = G.edges()
    live = {p: m[:, None] > 0 for p, m in em.items()}
    deg = C.ScatterSum(S, G.axes, G.region(), what="pna/deg")
    for p in S.run:
        deg.add(p, _seg_sum(em[p], ed[p], n))
    deg = deg.result()
    log_deg = {p: torch.log1p(d)[:, None] for p, d in deg.items()}
    # the mean over the whole (n, 1) column, gathered: the scalers'
    # gradient magnifies this float32 scalar's last bit some 10^3 times,
    # and one torch.mean over the same column gives the unpartitioned
    # step's bits
    mean_log_deg = {p: torch.mean(G.gather(log_deg, p, 1, "pna/log_deg"))
                    + 1e-6 for p in S.run}
    deg1 = {p: torch.clamp(d, min=1.0)[:, None] for p, d in deg.items()}
    dh = cfg.d_hidden
    for i in range(cfg.n_layers):
        z = {p: torch.relu(h[p] @ w("w_pre", i)[p]) for p in S.run}
        sums = C.ScatterSum(S, G.axes, G.region(dh), what=f"pna/{i}/sum")
        sqs = C.ScatterSum(S, G.axes, G.region(dh), what=f"pna/{i}/sq")
        tops, ties = {}, {}
        pieces = [z[q] for q in S.run]
        for p in S.run:
            def fn(*pieces, p=p, i=i):
                full = G.gather(dict(zip(S.run, pieces)), p, dh, f"pna/{i}")
                zs = full.index_select(0, es[p])
                del full
                msgs = zs * em[p][:, None]
                data = torch.cat([torch.where(live[p], zs, -1e30),
                                  -torch.where(live[p], zs, 1e30)], -1)
                top, tie = _TiedMax.apply(data, ed[p], n)
                return msgs, msgs * msgs, top, tie
            msgs, sq, tops[p], ties[p] = _remat(fn, pieces)
            sums.add(p, _seg_sum(msgs, ed[p], n))
            sqs.add(p, _seg_sum(sq, ed[p], n))
            del msgs, sq
        s_sum, sq = sums.result(), sqs.result()
        top = C.reduce_scatter(S, tops, G.axes, G.region(2 * dh),
                               dtype=tops[S.run[0]].dtype,
                               what=f"pna/{i}/max", op="max", counts=ties)
        del tops, ties
        nxt = {}
        for p in S.run:
            s_max = torch.where(torch.isfinite(top[p][:, :dh]),
                                top[p][:, :dh], 0.0)
            s_min = -top[p][:, dh:]
            s_min = torch.where(torch.isfinite(s_min), s_min, 0.0)
            s_mean = s_sum[p] / deg1[p]
            s_std = _pna_std(sq[p] / deg1[p] - s_mean ** 2)
            aggs = {"mean": s_mean, "max": s_max, "min": s_min,
                    "std": s_std, "sum": s_sum[p]}
            cols = []
            for a in cfg.aggregators:
                base = aggs[a]
                for s in cfg.scalers:
                    if s == "identity":
                        cols.append(base)
                    elif s == "amplification":
                        cols.append(base * (log_deg[p] / mean_log_deg[p]))
                    elif s == "attenuation":
                        cols.append(base * (mean_log_deg[p] / torch.clamp(
                            log_deg[p], min=1e-6)))
            nxt[p] = torch.relu(torch.cat(cols + [h[p]], dim=-1)
                                @ w("w_post", i)[p])
        h = nxt
    return {p: x @ w("w_out")[p] for p, x in h.items()}


def _graphcast(cfg, G, w, f):
    S, dh = G.S, cfg.d_hidden
    n_grid = G.rows("n_grid")
    h = {}
    for p in S.run:
        grid = (G.lo[p] + torch.arange(G.n_l, device=f[p].device)) \
            < n_grid[p]
        h[p] = torch.where(grid[:, None],
                           torch.relu(f[p] @ w("enc_grid")[p]),
                           torch.relu(f[p] @ w("enc_mesh")[p]))

    def exchange(h, which, wt, what):
        src, dst, mask = G.edges(which)

        def work(p, full):
            both = torch.stack([src[p], dst[p]], 1).reshape(-1)
            pair = full.index_select(0, both).reshape(-1, 2 * dh)
            return torch.relu(pair @ wt[p]) * mask[p][:, None]
        return G.exchange(h, dh, dh, work, dst, what)

    agg = exchange(h, "g2m", w("g2m_edge"), "graphcast/g2m")
    h = {p: h[p] + agg[p] for p in S.run}
    for i in range(cfg.n_layers):
        agg = exchange(h, "", w("proc_edge", i), f"graphcast/{i}")
        h = {p: h[p] + torch.relu(torch.cat([h[p], agg[p]], -1)
                                  @ w("proc_node", i)[p]) for p in S.run}
    agg = exchange(h, "m2g", w("m2g_edge"), "graphcast/m2g")
    return {p: (h[p] + agg[p]) @ w("dec")[p] for p in S.run}


_KINDS = {"gcn": _gcn, "gat": _gat, "pna": _pna, "graphcast": _graphcast}


def _loss(cfg, G, out):
    """The masked mean NLL (``n_classes > 0``, from float32 logits) or
    squared error (in the outputs' dtype) over every position's rows, as
    ``gnn.loss_fn`` forms them: each position's sum and mask count,
    all-reduced in position order, on the first position's device."""
    S = G.S
    mask = G.rows("node_mask")
    tots = {}
    for p in S.run:
        m = mask[p].to(F32)
        if cfg.n_classes > 0:
            logits = out[p].to(F32)
            logz = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(
                -1, G.st["labels"].pieces[p].long()[:, None])[:, 0]
            tot = ((logz - gold) * m).sum()
        else:
            err = (out[p] - G.st["targets"].pieces[p]) ** 2
            tot = (err.mean(-1) * m).sum()
        tots[p] = torch.stack([tot, m.sum().to(tot.dtype)])
    tot = C.all_reduce(S, tots, G.axes, what="loss")[S.run[0]]
    return tot[0] / torch.clamp(tot[1], min=1.0)


def _program(params, batch):
    """(the placed weights, the batch read as :class:`_Graph`)."""
    from repro_torch.models.transformer_sharded import place_params
    mesh = active_mesh()
    if mesh is None:
        raise ValueError("the partitioned GNN step needs an active mesh "
                         "(launch.sharding.use_mesh_rules)")
    leaves = place_params(params, mesh)
    return leaves, _Graph(batch, mesh, leaves)


def _forward(cfg, G, w):
    """{p: the model's outputs at p's rows}."""
    x = G.rows("feats")
    if cfg.sim_feats > 0:
        sim = G.rows("sim_feat")
        x = {p: torch.cat([f, sim[p]], -1) for p, f in x.items()}
    return _KINDS[cfg.kind](cfg, G, w, x)


@torch.no_grad()
def loss_sharded(cfg, params, batch):
    """``gnn.loss_fn`` of ``params`` (a ``GNNParams`` or {tree path:
    ShardedTensor}) on ``batch`` (placed or whole leaves; whole ones are
    placed over the node axes here), one program a mesh position; the
    loss on the first position's device. Needs an active mesh."""
    leaves, G = _program(params, batch)
    w = _weights(leaves, {path: {p: st.pieces[p] for p in G.S.run}
                               for path, st in leaves.items()})
    return _loss(cfg, G, _forward(cfg, G, w))


def value_and_grad(cfg, params, batch):
    """(the loss (on the mesh's first position's device), {tree path:
    {position: the gradient of that position's copy}}) of ``loss_fn``
    over placed parameters and a placed or whole batch, one program a
    position (see the module docstring). Each copy of a weight gets the
    sum of every position's gradient, for the positions that ran."""
    leaves, G = _program(params, batch)
    S = G.S
    req = {path: {p: st.pieces[p].detach().requires_grad_()
                  for p in S.run} for path, st in leaves.items()}
    w = _weights(leaves, req)
    with torch.enable_grad():
        loss = _loss(cfg, G, _forward(cfg, G, w))
    flat = [(path, p) for path in req for p in S.run]
    grads = torch.autograd.grad(loss, [req[path][p] for path, p in flat],
                                allow_unused=True)
    local = {p: [] for p in S.run}
    for (path, p), g in zip(flat, grads):
        local[p].append(torch.zeros_like(req[path][p]) if g is None else g)
    with torch.no_grad():
        tot = C.all_reduce(
            S, {p: torch.cat([g.reshape(-1) for g in gs])
                for p, gs in local.items()}, G.axes, what="grads")
    out = {path: {} for path in req}
    for p in S.run:
        at = 0
        for path in req:
            shape = req[path][p].shape
            size = math.prod(shape)
            out[path][p] = tot[p][at:at + size].view(shape)
            at += size
    return loss.detach(), out
