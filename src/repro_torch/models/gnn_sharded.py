"""Node-sharded GCN: dst-partitioned edges, one all-gather of the hidden
state a layer (port of ``repro/models/gnn_sharded.py``).

The nodes split into NS contiguous shards over the active mesh's node
axes (``_node_axes``: "pod", "data" and "model", those of size > 1, in
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
back to the shards, the reference's reduce-scatter). Plain torch ops:
the reference's message passing is XLA's, outside any Pallas kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.cost import collective
from repro_torch.launch.sharding import ShardedTensor, active_mesh
from repro_torch.models.layers import segment_sum


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
