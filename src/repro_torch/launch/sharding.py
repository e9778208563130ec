"""Logical-axis sharding rules (MaxText-style) and the placements they
give (port of ``repro/launch/sharding.py``).

Models name an activation's dimensions with *logical* names and
parameters get a spec from ``param_spec``'s rule table. Rules map a
logical name to a mesh axis or a tuple of axes; a rule applies only
where the dimension divides by the product of the axes' sizes, else the
dimension falls through to the next candidate or is replicated. The
active mesh and rules live in a context set by ``use_mesh_rules``;
without one every spec is ``()``.

A spec is a tuple with one entry per dimension, ``None`` or a tuple of
axis names: ``tuple()`` of the reference's ``PartitionSpec``.
:class:`NamedSharding` pairs a mesh and a spec, as JAX's does, and
:func:`place` cuts a tensor under one into the grid of contiguous
pieces the spec names, a piece at each mesh position (a position whose
axes the spec leaves out holds a copy). The port's sharding is
single-controller: a piece is a tensor on its position's device, and
``logical`` changes nothing (a sharding constraint does not change
values), though under a mesh it still resolves its names.

The SLING arrays keep the reference's two tables of their own
(``sling_index_specs``, ``sling_build_specs``) in the form ``(axis,
dim)``: dimension ``dim`` cut into ``mesh.shape[axis]`` contiguous
pieces along ``mesh.axis_devices(axis)``; ``None`` means a copy on each
of those devices. One table, so that ``shard_query.shard_index`` and the
fan-out that reads its slabs, and the build and walk splits, cannot
drift apart.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from typing import Any, Optional, Sequence

import torch

from repro_torch.kernels.cost import is_fake
from repro_torch.optim.adamw import AdamWState, named_leaves, state_leaves

_CTX: dict[str, Any] = {"mesh": None, "rules": None}

# Each logical name maps to a preference list of mesh-axis assignments;
# the first candidate whose axes all exist in the mesh AND divide the
# dimension is used. `None` = replicate.
DEFAULT_RULES: dict[str, list[Any]] = {
    # --- activations ---
    "batch":        [("pod", "data"), ("data",)],
    "seq":          [None],
    "q_seq":        [("model",)],   # sequence-parallel attention (train/prefill)
    "kv_time":      [None],         # kv positions replicated over model
    "kv_seq":       [None],         # decode cells override to ("model",)
    "heads":        [("model",)],
    "kv_heads":     [("model",)],
    "head_dim":     [("model",)],   # fallback TP when head counts don't divide
    "embed":        [None],
    "dff":          [("model",)],
    "vocab":        [("model",)],
    "experts":      [("model",)],
    "capacity":     [("pod", "data"), ("data",)],
    "tokens":       [("pod", "data"), ("data",)],   # flattened T*k routing dim
    # --- graph / recsys activations ---
    "nodes":        [("pod", "data", "model"), ("data", "model")],
    "edges":        [("pod", "data", "model"), ("data", "model")],
    "feat":         [None],
    "table_rows":   [("model",)],
    "fields":       [None],
    "candidates":   [("pod", "data", "model"), ("data", "model")],
    # --- weight dims (FSDP axis) ---
    "embed_w":      [("pod", "data"), ("data",)],
    "dff_w":        [("model",)],
    "heads_w":      [("model",)],
    "kv_heads_w":   [("model",)],
    "head_dim_w":   [("model",)],
    "vocab_w":      [("model",)],
    "experts_w":    [("model",)],
    "layers":       [None],
    "hidden_w":     [None],
    "table_rows_w": [("model",)],
}


@contextlib.contextmanager
def use_mesh_rules(mesh, rules: Optional[dict] = None):
    """Make ``mesh`` and ``DEFAULT_RULES`` updated by ``rules`` the
    active context inside the block."""
    prev = dict(_CTX)
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    _CTX["mesh"], _CTX["rules"] = mesh, merged
    try:
        yield
    finally:
        _CTX.update(prev)


def active_mesh():
    return _CTX["mesh"]


def data_group_count() -> int:
    """Product of the data-parallel mesh axes (1 without a mesh): the
    number of token groups the MoE layer dispatches on their own."""
    mesh = _CTX["mesh"]
    if mesh is None:
        return 1
    g = 1
    for ax in ("pod", "data"):
        g *= mesh.shape.get(ax, 1)
    return g


def _resolve_axis(name: Optional[str], dim: int, mesh, used: set,
                  exact: bool):
    """The first viable candidate for a logical name: its axes all in
    the mesh and none used yet, their size dividing ``dim`` (or, with
    ``exact=False``, at most ``dim``); always a tuple of axes."""
    if name is None:
        return None
    rules = _CTX["rules"] or DEFAULT_RULES
    for cand in rules.get(name, [None]):
        if cand is None:
            return None
        axes = (cand,) if isinstance(cand, str) else tuple(cand)
        if not all(a in mesh.shape for a in axes):
            continue
        if any(a in used for a in axes):
            continue
        size = math.prod(mesh.shape[a] for a in axes)
        if dim % size == 0 or (not exact and dim >= size):
            return axes
    return None


def spec_for(shape: Sequence[int], names: Sequence[Optional[str]],
             mesh=None, allow_uneven: bool = False) -> tuple:
    """Two-round assignment: round 1 gives every dim its best
    exactly-divisible candidate (so head_dim=128 wins the "model" axis
    over heads=40 on a 16-way axis); round 2 (``allow_uneven``,
    activations only) fills the remaining dims with uneven candidates,
    e.g. 40 heads over a 16-way axis. ``()`` without a mesh."""
    mesh = mesh or _CTX["mesh"]
    if mesh is None:
        return ()
    if len(shape) != len(names):
        raise ValueError(f"{len(names)} logical names {tuple(names)} for "
                         f"shape {tuple(shape)}")
    used: set[str] = set()
    parts: list = [None] * len(shape)
    rounds = (True, False) if allow_uneven else (True,)
    for exact in rounds:
        for i, (dim, name) in enumerate(zip(shape, names)):
            if parts[i] is not None:
                continue
            ax = _resolve_axis(name, dim, mesh, used, exact)
            if ax is None:
                continue
            used.update(ax)
            parts[i] = ax
    return tuple(parts)


def logical(x, *names: Optional[str]):
    """``x`` unchanged. Under a mesh the names are resolved through
    ``spec_for`` (so a wrong count raises), but nothing is placed: the
    reference's ``with_sharding_constraint`` does not change values."""
    mesh = _CTX["mesh"]
    if mesh is not None:
        spec_for(tuple(x.shape), names, mesh, allow_uneven=True)
    return x


# ----------------------------------------------------------------------
# placements: a mesh and a spec
# ----------------------------------------------------------------------
def _bounds(n: int, k: int, i: int) -> tuple[int, int]:
    """Piece i of k of a length-n dimension: ``torch.tensor_split``'s
    (the first n % k pieces one longer; an even cut is JAX's)."""
    q, r = divmod(n, k)
    lo = i * q + min(i, r)
    return lo, lo + q + (i < r)


def _indices(shape: tuple, spec: tuple, mesh, positions=None) -> dict:
    """{mesh position: the index slices of its piece} of a tensor of
    ``shape`` under ``spec`` (missing trailing entries are ``None``),
    at ``positions`` (every position of the mesh, row-major, when
    None)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} has more entries than shape "
                         f"{shape}")
    names = mesh.axis_names
    if positions is None:
        positions = mesh.axes_positions(names)
    out = {}
    for pos in positions:
        at = dict(zip(names, pos))
        sl = []
        for n, axes in zip(shape, spec):
            if not axes:
                sl.append(slice(0, n))
                continue
            k, i = 1, 0
            for a in axes:             # row-major over the entry's axes
                k, i = k * mesh.shape[a], i * mesh.shape[a] + at[a]
            sl.append(slice(*_bounds(n, k, i)))
        out[pos] = tuple(sl)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A placement: ``mesh`` and ``spec`` (``jax.sharding.
    NamedSharding``)."""
    mesh: Any
    spec: tuple

    def devices_indices_map(self, shape) -> dict:
        """{mesh position: index slices of its piece}: the counterpart
        of JAX's map, keyed by position because a mesh may repeat a
        device."""
        return _indices(tuple(shape), self.spec, self.mesh)

    def shard(self, x: torch.Tensor) -> "ShardedTensor":
        return place(x, self.spec, self.mesh)


@dataclasses.dataclass(frozen=True)
class ShardedTensor:
    """A tensor of ``shape`` as ``pieces``: {mesh position: its piece on
    that position's device} under ``sharding``."""
    sharding: NamedSharding
    shape: tuple
    pieces: dict

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (the first position's device
        by default), each distinct piece copied there once: concatenated
        in order where the pieces cut one dimension, else each copied
        into its slices."""
        first = next(iter(self.pieces.values()))
        device = device if device is not None else first.device
        distinct = {}
        for pos, sl in self.sharding.devices_indices_map(self.shape).items():
            distinct.setdefault(tuple((s.start, s.stop) for s in sl), pos)
        cut = [d for d, n in enumerate(self.shape)
               if len({k[d] for k in distinct}) > 1]
        if len(cut) == 1:
            return torch.cat([self.pieces[distinct[k]].to(device)
                              for k in sorted(distinct)], dim=cut[0])
        out = torch.empty(self.shape, dtype=first.dtype, device=device)
        for key, pos in distinct.items():
            out[tuple(slice(a, b) for a, b in key)] = \
                self.pieces[pos].to(device)
        return out


def place(x: torch.Tensor, spec, mesh, axis: str | None = None):
    """The pieces of ``x`` under ``spec`` on their devices. A piece
    already on its device is a view, not a copy; copies are
    ``non_blocking``.

    A spec with one entry per dimension (or fewer, the rest ``None``)
    gives a :class:`ShardedTensor` with a piece at every mesh position.
    A SLING spec gives a list in shard order: ``(axis, dim)``'s pieces
    along ``axis``, or for ``None`` ``x`` itself on each device along
    ``axis``."""
    if spec is None or (len(spec) == 2 and isinstance(spec[0], str)):
        ax = axis if spec is None else spec[0]
        dims = () if spec is None else (None,) * spec[1] + ((ax,),)
        positions = mesh.axes_positions((ax,))
        pieces = _pieces(x, dims, mesh, positions)
        return [pieces[p] for p in positions]
    return ShardedTensor(NamedSharding(mesh, tuple(spec)), tuple(x.shape),
                         _pieces(x, tuple(spec), mesh))


def _pieces(x: torch.Tensor, spec: tuple, mesh, positions=None) -> dict:
    """{position: x's piece there}; a fake ``x`` (the dry run's, no data
    to copy) gets new fake pieces of the pieces' shapes."""
    grid = mesh.devices
    idx = _indices(tuple(x.shape), spec, mesh, positions)
    if is_fake(x):
        return {pos: torch.empty([s.stop - s.start for s in sl],
                                 dtype=x.dtype, device=grid[pos])
                for pos, sl in idx.items()}
    return {pos: x[sl].to(grid[pos], non_blocking=True)
            for pos, sl in idx.items()}


# ----------------------------------------------------------------------
# node-sharded SLING serving state (core/shard_query.py, DESIGN.md §8)
# ----------------------------------------------------------------------
def sling_index_specs(axis: str = "data") -> dict:
    """The node-sharded serving state (``core/shard_query.py``): the
    packed HP rows, d and the dst-partitioned edges split their leading
    node (or shard) dimension; query ids are replicated."""
    row = (axis, 0)
    return {
        "keys": row,        # (n_pad, width_cap) packed H rows
        "vals": row,
        "d": row,           # (n_pad,) correction factors
        "edges": row,       # dst-partitioned edges, a slab layout a shard
        "queries": None,    # (B,) query ids: replicated
    }


def sling_build_specs(axis: str = "data") -> dict:
    """The mesh-parallel build (``hp_index.shard_build_hp``,
    ``walks.paired_meet``): a superblock of S * block seed columns
    splits its column dimension, so shard s propagates the block the
    single-device build would; walk batches split their one dimension.
    The graph, which every shard reads whole, is copied to each device
    as it is; the reference's "replicated" entry is left out, since
    nothing reads it."""
    return {
        "seeds": (axis, 1),     # (n, S * block) one-hot columns
        "walks": (axis, 0),     # (pairs,) live walk lanes
    }


# ----------------------------------------------------------------------
# parameter specs: rule table keyed by path regex -> logical dim names
# ----------------------------------------------------------------------
PARAM_RULES: list[tuple[str, tuple[Optional[str], ...]]] = [
    # transformer
    (r"^embed$",           ("vocab_w", "embed_w")),
    (r"blocks/ln\d?$",     ("layers", None)),
    (r"blocks/(qnorm|knorm)$", ("layers", None)),
    (r"blocks/wq$",        ("layers", "embed_w", "heads_w", "head_dim_w")),
    (r"blocks/wk$",        ("layers", "embed_w", "kv_heads_w", "head_dim_w")),
    (r"blocks/wv$",        ("layers", "embed_w", "kv_heads_w", "head_dim_w")),
    (r"blocks/wo$",        ("layers", "heads_w", "head_dim_w", "embed_w")),
    (r"blocks/w_(gate|up)$",  ("layers", "embed_w", "dff_w")),
    (r"blocks/w_down$",    ("layers", "dff_w", "embed_w")),
    (r"blocks/router$",    ("layers", "embed_w", None)),
    (r"blocks/moe_w_(gate|up)$", ("layers", "experts_w", "embed_w", "dff_w")),
    (r"blocks/moe_w_down$", ("layers", "experts_w", "dff_w", "embed_w")),
    (r"ln_f$",             (None,)),
    # gnn
    (r"gnn/.*w\d?$",       ("hidden_w", None)),
    (r"gnn/.*",            (None,)),
    # recsys: stacked per-field tables (F, V, D) -- shard vocab rows
    (r"tables/.*",         (None, "table_rows_w", None)),
    (r"recsys/.*",         (None,)),
]


def param_spec(path: str, shape: Sequence[int], mesh=None) -> tuple:
    """The spec of the leaf at ``path``: the first rule whose regex
    matches names its dimensions (a rank mismatch replicates)."""
    mesh = mesh or _CTX["mesh"]
    if mesh is None:
        return ()
    for pat, names in PARAM_RULES:
        if re.search(pat, path):
            if len(names) != len(shape):
                return ()
            return spec_for(shape, names, mesh)
    return ()


def tree_paths(tree) -> list[tuple[str, Any]]:
    """[(path, leaf)] in ``jax.tree`` order under the reference's path
    strings ("blocks/wq", "gnn/w/0", "tables/embed"): a module's
    parameters, a nested dict / list, or an ``AdamWState`` (".step",
    ".m/<name>", ".v/<name>")."""
    if isinstance(tree, AdamWState):
        return state_leaves(tree)
    return named_leaves(tree)


def tree_specs(tree, mesh=None) -> dict:
    """{path: spec} of every leaf of ``tree``, in :func:`tree_paths`
    order."""
    mesh = mesh or _CTX["mesh"]
    return {path: param_spec(path, tuple(getattr(leaf, "shape", ())), mesh)
            for path, leaf in tree_paths(tree)}


def tree_shardings(tree, mesh=None) -> dict:
    """{path: NamedSharding} of every leaf of ``tree`` on ``mesh``."""
    mesh = mesh or _CTX["mesh"]
    return {path: NamedSharding(mesh, spec)
            for path, spec in tree_specs(tree, mesh).items()}
