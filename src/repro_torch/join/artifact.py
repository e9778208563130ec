"""The ``KnnGraph`` artifact: a materialized SimRank similarity join.

Port of ``repro/join/artifact.py`` (NumPy only, as there). A bulk sweep
(:mod:`repro_torch.join.sweep`) produces, for every swept source node,
its k most-similar nodes (or every node with ``sim >= tau``) as a CSR
over the source set:

    row i  =  nbr_ids[indptr[i]:indptr[i+1]]   (scores aligned,
              descending per row, ties toward the smaller node id)

plus the *eps certificate*: the plan parameters (eps, c, theta, l_max)
of the index the sweep ran against, so a consumer knows every stored
score is within the planned eps of exact SimRank (Theorem 1), and the
index ``epoch`` at sweep time, so the serving layer can refuse to
answer from an artifact that predates a hot-swap
(:meth:`repro_torch.serve.QueryEngine.knn`).

The file is the reference's ``.npz`` layout under the same member and
meta names (INDEX_FORMAT.md, "KnnGraph artifact"), so each package
loads the other's artifact. ``load`` enforces the same rules: read up
to its own version, refuse the future, refuse unknown meta fields,
validate the CSR before any lookup.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

KNN_FORMAT_VERSION = 1   # on-disk layout version; rules in INDEX_FORMAT.md
CKPT_FORMAT_VERSION = 1  # sweep-checkpoint sidecar version

# every legal meta field; anything else in a loaded file is refused (a
# silently dropped field could misreport the error budget or staleness)
_META_FIELDS = {"_format_version", "mode", "k", "tau", "cap",
                "exclude_self", "tile", "eps", "c", "theta", "l_max",
                "epoch", "n", "mesh_shards"}


@dataclasses.dataclass
class KnnGraph:
    """A materialized top-k / threshold SimRank join over ``sources``."""
    n: int                   # node count of the underlying graph
    mode: str                # "topk" | "threshold"
    k: int                   # requested k (topk) / candidate cap (threshold)
    tau: float | None        # similarity threshold (threshold mode)
    exclude_self: bool
    tile: int                # source-tile shape of the sweep
    eps: float               # the certificate: plan eps of the index
    c: float
    theta: float
    l_max: int
    epoch: int               # index epoch at sweep time (staleness check)
    mesh_shards: int         # provenance only; results are mesh-invariant
    sources: np.ndarray      # (S,) int32 swept node ids (unique)
    indptr: np.ndarray       # (S+1,) int64
    nbr_ids: np.ndarray      # (nnz,) int32
    nbr_scores: np.ndarray   # (nnz,) float32, descending per row
    truncated: np.ndarray | None = None  # (S,) bool, threshold mode only
    _pos: np.ndarray | None = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def nbytes(self) -> int:
        total = (self.sources.nbytes + self.indptr.nbytes
                 + self.nbr_ids.nbytes + self.nbr_scores.nbytes)
        if self.truncated is not None:
            total += self.truncated.nbytes
        return total

    def _positions(self) -> np.ndarray:
        if self._pos is None:
            pos = np.full(self.n, -1, np.int64)
            pos[self.sources] = np.arange(len(self.sources))
            self._pos = pos
        return self._pos

    def has(self, u: int) -> bool:
        """Was node ``u`` part of the swept source set?"""
        return 0 <= int(u) < self.n and self._positions()[int(u)] >= 0

    def neighbors(self, u: int) -> tuple[np.ndarray, np.ndarray]:
        """(ids, scores) of the stored row for source ``u``, scores
        descending. Raises ``KeyError`` for nodes outside the swept
        source set (a partial-sweep artifact only answers for its
        sources)."""
        if not self.has(u):
            raise KeyError(f"node {u} is not a source of this KnnGraph "
                           f"({len(self.sources)} sources over n={self.n})")
        i = int(self._positions()[int(u)])
        lo, hi = int(self.indptr[i]), int(self.indptr[i + 1])
        return self.nbr_ids[lo:hi], self.nbr_scores[lo:hi]

    def save(self, path: str) -> None:
        """Persist in the versioned layout (INDEX_FORMAT.md). Atomic: the
        payload goes to a sibling tmp file, is fsynced, then replaces
        ``path``, so a preemption mid-save leaves the previous artifact
        intact, never a torn file."""
        meta = {
            "_format_version": KNN_FORMAT_VERSION,
            "mode": self.mode, "k": int(self.k),
            "tau": None if self.tau is None else float(self.tau),
            "exclude_self": bool(self.exclude_self),
            "tile": int(self.tile), "eps": float(self.eps),
            "c": float(self.c), "theta": float(self.theta),
            "l_max": int(self.l_max), "epoch": int(self.epoch),
            "n": int(self.n), "mesh_shards": int(self.mesh_shards),
        }
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez_compressed(  # slinglint: disable=banned-api -- the atomic writer itself
                f, meta=json.dumps(meta), sources=self.sources,
                indptr=self.indptr, nbr_ids=self.nbr_ids,
                nbr_scores=self.nbr_scores,
                truncated=(self.truncated if self.truncated is not None
                           else np.zeros(0, bool)))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    @staticmethod
    def load(path: str) -> "KnnGraph":
        """Inverse of :meth:`save`: refuse files from a newer format
        version and unknown meta fields, and validate the CSR invariants
        before any lookup."""
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            arrays = {k: z[k] for k in ("sources", "indptr", "nbr_ids",
                                        "nbr_scores", "truncated")}
        version = meta.get("_format_version", 0)
        if version > KNN_FORMAT_VERSION:
            raise ValueError(
                f"KnnGraph file is format v{version}, this build reads "
                f"<= v{KNN_FORMAT_VERSION} (see INDEX_FORMAT.md)")
        unknown = set(meta) - _META_FIELDS
        if unknown:
            raise ValueError(f"KnnGraph meta has unknown fields "
                             f"{sorted(unknown)}; refusing to drop them "
                             "(INDEX_FORMAT.md)")
        sources = arrays["sources"].astype(np.int32)
        indptr = arrays["indptr"].astype(np.int64)
        ids = arrays["nbr_ids"].astype(np.int32)
        scores = arrays["nbr_scores"].astype(np.float32)
        n = int(meta["n"])
        S = len(sources)
        if indptr.shape != (S + 1,) or indptr[0] != 0 \
                or int(indptr[-1]) != len(ids) or len(ids) != len(scores):
            raise ValueError("KnnGraph CSR arrays are inconsistent: "
                             f"sources {sources.shape} indptr "
                             f"{indptr.shape} ids {ids.shape} scores "
                             f"{scores.shape}")
        if np.any(np.diff(indptr) < 0):
            raise ValueError("KnnGraph indptr is not monotone")
        if len(ids) and (ids.min() < 0 or ids.max() >= n):
            raise ValueError(f"KnnGraph neighbor id outside [0, {n})")
        if S == 0 or sources.min() < 0 or sources.max() >= n:
            # a negative source would wrap around in the row-position
            # table and silently serve another node's row
            raise ValueError(f"KnnGraph source id outside [0, {n}) "
                             "(or empty source set)")
        if S != len(np.unique(sources)):
            raise ValueError("KnnGraph sources are not unique")
        truncated = (arrays["truncated"].astype(bool)
                     if arrays["truncated"].size else None)
        return KnnGraph(
            n=n, mode=str(meta["mode"]), k=int(meta["k"]),
            tau=(None if meta["tau"] is None else float(meta["tau"])),
            exclude_self=bool(meta["exclude_self"]),
            tile=int(meta["tile"]), eps=float(meta["eps"]),
            c=float(meta["c"]), theta=float(meta["theta"]),
            l_max=int(meta["l_max"]), epoch=int(meta["epoch"]),
            mesh_shards=int(meta["mesh_shards"]), sources=sources,
            indptr=indptr, nbr_ids=ids, nbr_scores=scores,
            truncated=truncated)
