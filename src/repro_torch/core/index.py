"""The SLING index object, single-pair queries (Alg 3), and the on-disk
artifact formats.

Port of ``repro/core/index.py``. Index = { d~_k for all k } + packed HP
table { H(v) for all v }. Single-pair query: s~(u,v) = sum over
matching (l,k) keys of h~(u;l,k) * d_k * h~(v;l,k).

  * ``query_pair_host``    -- scalar merge join on the host (float64),
    re-materializing the Section-5.2 step-1/2 entries of reduced rows and
    the Section-5.3 enhancement (``_host_entries``, with the graph);
  * ``_pair_query_batch``  -- batched searchsorted join as torch ops
    (the reference's vmapped join, one row of the batch per query).

On disk (INDEX_FORMAT.md): **format v3** is a raw-array container --
magic + version + JSON header + 64-byte-aligned fixed-width arrays --
and the files this module writes equal the reference's byte for byte.
``load(mmap=True)`` is zero-copy: the tensors are host views over
read-only ``np.memmap`` pages, which processes serving one artifact
share. Such an index is ``read_only``; ``update_index`` refuses it,
since a write through a read-only mapping faults the process instead of
raising. It still serves on the card: ``QueryEngine`` and the one-shot
paths upload what they need to the device they run on. An eager load
puts the tensors on ``device`` (``cuda`` unless ``device="cpu"``).
v1/v2 ``.npz`` archives load (sniffed by magic) and v2 can be written.
Both versions refuse files from a future version and unknown plan,
header, quantization or array fields rather than dropping them.
Quantized artifacts (``core/quantize.py``) keep vals as codes in memory
(bf16 members are read as int16 and viewed as ``torch.bfloat16``);
serving dequantizes through ``vals_f32``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
import warnings

import numpy as np
import torch

from repro_torch.core import quantize as quantization
from repro_torch.core import theory
from repro_torch.core.hp_index import INT32_PAD_KEY, HPTable
from repro_torch.core.quantize import QuantInfo
from repro_torch.device import resolve_device

FORMAT_VERSION = 3  # on-disk layout version; rules in INDEX_FORMAT.md
V3_MAGIC = b"SLINGIDX"
_V3_ALIGN = 64
# every array member a v3 file may carry; anything else is refused
_V3_MEMBERS = ("d", "keys", "vals", "counts", "reduced", "marks")
_V3_HEADER_KEYS = {"plan", "stale", "epoch", "quant", "arrays",
                   "builder", "uncertified_d"}
# builder provenance a v3 header may carry; an unknown builder is
# refused on load (its certificate cannot be vouched for)
KNOWN_BUILDERS = ("sling", "prsim")
_BF16 = "bfloat16"   # the header's dtype string for bf16 members
# dtype of a vals or counts tensor -> the dtype its bytes take in a file
_FILE_DTYPES = {torch.float32: np.dtype(np.float32),
                torch.int32: np.dtype(np.int32),
                torch.int16: np.dtype(np.int16),
                torch.bfloat16: _BF16}


@dataclasses.dataclass
class SlingIndex:
    """The reference's fields in its order, then the port's own
    (keyword-only)."""
    plan: theory.SlingPlan
    d: torch.Tensor        # (n,) float32 correction factors
    hp: HPTable
    # Section-5.2 space reduction: (n,) bool host array, rows whose
    # step-1/2 entries were dropped (only the host path, given the
    # graph, re-materializes them; QueryEngine refuses such an index)
    reduced: np.ndarray | None = None
    # Section-5.3 enhancement marks: (n, n_marks) int32 host array of
    # row offsets, -1 = none
    marks: np.ndarray | None = None
    stale: float = 0.0     # staleness charged against plan.eps_stale
    epoch: int = 0         # bumped by every applied update batch
    # the recipe when hp.vals are int16/bf16 codes; None = float32
    quant: QuantInfo | None = None
    builder: str = "sling"
    # True when d carries no eps_d certificate; QueryEngine refuses it
    # unless EngineConfig.allow_uncertified
    uncertified_d: bool = False
    _: dataclasses.KW_ONLY
    # wall seconds of the build phases ({"d": .., "hp": ..}), if built
    build_seconds: dict = dataclasses.field(default_factory=dict)
    # True for a mapped artifact: the storage is a read-only mapping
    read_only: bool = False

    @property
    def n(self) -> int:
        return self.hp.n

    @property
    def device(self) -> torch.device:
        """Where the index's storage lies (host memory when mapped)."""
        return self.d.device

    # ------------------------------------------------------------------
    # float32 views over possibly quantized storage
    # ------------------------------------------------------------------
    def vals_f32(self, row: int | None = None,
                 device=None) -> torch.Tensor:
        """HP vals as float32 -- the one dequantization seam of every
        serving consumer. ``device`` moves the stored codes there first
        (an int16 upload is half a float32 one), then dequantizes; no
        copy for a float32 index already there."""
        v = self.hp.vals if row is None else self.hp.vals[row]
        if device is not None:
            v = v.to(device)
        if self.quant is None:
            return v.to(torch.float32)
        return quantization.dequantize_vals(v, self.quant)

    def dequantized_hp(self) -> HPTable:
        """A float32-vals HPTable (self.hp itself when not quantized);
        keys and counts are shared either way."""
        if self.quant is None:
            return self.hp
        return HPTable(n=self.hp.n, width=self.hp.width,
                       keys=self.hp.keys, vals=self.vals_f32(),
                       counts=self.hp.counts, theta=self.hp.theta,
                       sqrt_c=self.hp.sqrt_c, l_max=self.hp.l_max)

    def nbytes(self) -> int:
        return self.hp.nbytes() + self.d.numel() * self.d.element_size()

    def refuse_reduced(self, what: str) -> None:
        """Raise if a row was space-reduced: the batched paths read the
        packed rows as they are, without the step-1/2 entries that only
        the host path re-materializes."""
        if self.reduced is not None and np.asarray(self.reduced).any():
            raise ValueError(
                f"{what} cannot serve a space-reduced index: its packed "
                "rows lack the step-1/2 entries of the reduced rows. Use "
                "query_pair_host(u, v, g), or build without space_reduce")

    # ------------------------------------------------------------------
    # host single-pair query (Alg 3, merge join)
    # ------------------------------------------------------------------
    def _host_entries(self, v: int, g=None):
        """Keys (int64) and vals (float64) of H(v) on the host,
        re-materializing dropped step-1/2 entries (Section 5.2) and the
        enhancement (Section 5.3) when the graph is given."""
        from repro_torch.core import optimizations
        cnt = int(self.hp.counts[v])
        keys = self.hp.keys[v, :cnt].cpu().numpy().astype(np.int64)
        vals = self.vals_f32(v)[:cnt].cpu().numpy().astype(np.float64)
        if self.reduced is not None and self.reduced[v]:
            if g is None:
                raise ValueError("a reduced row needs the graph at query "
                                 "time: pass g")
            k2, v2 = optimizations.exact_step12(g, v, self.plan.sqrt_c)
            keep = (keys // self.n == 0) | (keys // self.n > 2)
            keys = np.concatenate([keys[keep], k2])
            vals = np.concatenate([vals[keep], v2])
            order = np.argsort(keys)
            keys, vals = keys[order], vals[order]
        if self.marks is not None and g is not None:
            keys, vals = optimizations.enhance_entries(self, g, v, keys,
                                                       vals)
        return keys, vals

    def query_pair_host(self, u: int, v: int, g=None) -> float:
        """Alg 3 as a scalar merge join over H(u) and H(v), float64."""
        ku, vu = self._host_entries(u, g)
        kv, vv = self._host_entries(v, g)
        d = self.d.cpu().numpy()
        n = self.n
        i = j = 0
        s = 0.0
        while i < len(ku) and j < len(kv):
            a, b = ku[i], kv[j]
            if a == b:
                s += vu[i] * float(d[a % n]) * vv[j]
                i += 1
                j += 1
            elif a < b:
                i += 1
            else:
                j += 1
        return float(s)

    def device_arrays(self, device=None):
        """(keys, float32 vals, d) on ``device`` (``cuda`` unless
        ``device="cpu"``), warm-cached per index epoch
        (``core/device_state.py``), so repeated one-shot queries skip the
        upload."""
        from repro_torch.core import device_state
        ia = device_state.index_arrays(self, device)
        return ia.keys, ia.vals, ia.d

    def query_pairs(self, us, vs, device=None) -> np.ndarray:
        """Batched device pair join on ``device`` (``cuda`` unless
        ``device="cpu"``), whatever device the storage lies on."""
        self.refuse_reduced("query_pairs")
        keys, vals, d = self.device_arrays(device)
        dev = d.device
        return _pair_query_batch(
            keys, vals, d,
            torch.as_tensor(np.asarray(us), dtype=torch.int64, device=dev),
            torch.as_tensor(np.asarray(vs), dtype=torch.int64, device=dev),
            self.n).cpu().numpy()

    # ------------------------------------------------------------------
    def save(self, path: str, version: int = FORMAT_VERSION) -> None:
        """Persist in the layout of INDEX_FORMAT.md: ``version=3``
        (default) the raw-array container, ``version=2`` the legacy
        ``.npz`` (float32, sling-built, certified indexes only). Both
        writers are atomic (tmp file + ``os.replace``)."""
        if version == 3:
            _save_v3(self, path)
        elif version == 2:
            if self.quant is not None:
                raise ValueError("format v2 cannot carry a quantized "
                                 "index; save as v3 (INDEX_FORMAT.md)")
            if self.builder != "sling" or self.uncertified_d:
                raise ValueError(
                    "format v2 has no builder/uncertified_d metadata "
                    "slots; a reader would silently assume a certified "
                    "sling build -- save as v3 (INDEX_FORMAT.md)")
            _save_v2(self, path)
        else:
            raise ValueError(f"cannot write format v{version}; this "
                             f"build writes v2 and v3")

    @staticmethod
    def load(path: str, mmap: bool = False, validate: bool | None = None,
             device=None) -> "SlingIndex":
        """Inverse of :meth:`save`, enforcing INDEX_FORMAT.md's rules.

        An eager load puts the tensors on ``device`` (``cuda`` unless
        ``device="cpu"``). ``mmap=True`` (v3 only) returns read-only host
        views over the file's pages, in O(1) whatever the index's size;
        ``device`` must then be None or the CPU. The packed-row scan is
        O(n * width), so ``validate`` defaults to ``not mmap``; header
        shape and truncation checks always run.
        """
        if mmap and device is not None \
                and torch.device(device).type != "cpu":
            raise ValueError("mmap=True maps the file into host memory; "
                             "the engine uploads from there to its own "
                             "device")
        dev = torch.device("cpu") if mmap else resolve_device(device)
        with open(path, "rb") as f:
            magic = f.read(8)
        if magic[:8] == V3_MAGIC:
            return _load_v3(path, mmap=mmap, validate=validate, dev=dev)
        if magic[:2] == b"PK":  # zip archive: the v1/v2 .npz layout
            if mmap:
                raise ValueError(
                    "v1/v2 .npz archives cannot be memory-mapped; "
                    "re-save as format v3 first (INDEX_FORMAT.md)")
            return _load_v2(path, validate=True if validate is None
                            else validate, dev=dev)
        raise ValueError(f"{path} is not a SLING index artifact "
                         "(bad magic; see INDEX_FORMAT.md)")


# ----------------------------------------------------------------------
# shared validation
# ----------------------------------------------------------------------
def _check_shapes(n, width, d, vals, counts):
    if d.shape != (n,) or vals.shape != (n, width) \
            or counts.shape != (n,):
        raise ValueError("index arrays are inconsistent: "
                         f"keys {(n, width)} d {d.shape} "
                         f"vals {vals.shape} counts {counts.shape}")


def _validate_packed(plan: theory.SlingPlan, n: int, width: int,
                     keys: np.ndarray, counts: np.ndarray) -> None:
    """The packed-row invariants INDEX_FORMAT.md lets readers rely on:
    live prefix within width, strictly increasing live keys, every live
    key decoding to l <= l_max, k < n."""
    if counts.size and (counts.min() < 0 or counts.max() > width):
        raise ValueError("counts outside [0, width] "
                         "(INDEX_FORMAT.md invariants)")
    live = np.arange(width)[None, :] < counts[:, None]
    key_cap = np.int64(plan.l_max + 1) * np.int64(n)
    if np.any(live & ((keys < 0) | (keys.astype(np.int64) >= key_cap))):
        raise ValueError("live key outside [0, (l_max+1)*n) "
                         "(INDEX_FORMAT.md invariants)")
    if width > 1 and np.any(
            (np.arange(1, width)[None, :] < counts[:, None])
            & (np.diff(keys.astype(np.int64), axis=1) <= 0)):
        raise ValueError("row keys not strictly increasing over "
                         "the live prefix (INDEX_FORMAT.md "
                         "invariants)")


def _parse_plan(meta: dict) -> theory.SlingPlan:
    """Unknown plan fields are refused (a dropped knob would misreport
    the error budget); underscore-prefixed metadata is additive."""
    known = {f.name for f in dataclasses.fields(theory.SlingPlan)}
    unknown = {k for k in meta if not k.startswith("_")} - known
    if unknown:
        raise ValueError(f"index plan has unknown fields {unknown}; "
                         "refusing to drop them (INDEX_FORMAT.md)")
    return theory.SlingPlan(**{k: v for k, v in meta.items()
                               if k in known})


def _host(t) -> np.ndarray:
    """A tensor's bytes as a host NumPy array (bf16 viewed as int16)."""
    if isinstance(t, np.ndarray):
        return t
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.detach().cpu().numpy()


def _as_tensor(a: np.ndarray, dtype_str: str, dev) -> torch.Tensor:
    """A host array as a tensor on ``dev``: a view when ``dev`` is the
    CPU (read-only for a mapping), bf16 from its int16 bytes."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore",
                                message="The given NumPy array is not "
                                        "writable")
        t = torch.from_numpy(a)
    if dtype_str == _BF16:
        t = t.view(torch.bfloat16)
    return t.to(dev)


# ----------------------------------------------------------------------
# legacy v2 .npz reader/writer
# ----------------------------------------------------------------------
def _save_v2(idx: SlingIndex, path: str) -> None:
    path = os.fspath(path)
    meta = dataclasses.asdict(idx.plan)
    meta["_format_version"] = 2
    meta["_stale"] = float(idx.stale)
    meta["_epoch"] = int(idx.epoch)
    tmp = path + ".tmp.npz"
    np.savez_compressed(  # slinglint: disable=banned-api -- the atomic writer itself (tmp + os.replace below)
        tmp, d=_host(idx.d), keys=_host(idx.hp.keys),
        vals=_host(idx.hp.vals), counts=_host(idx.hp.counts),
        reduced=(idx.reduced if idx.reduced is not None
                 else np.zeros(0, bool)),
        marks=(idx.marks if idx.marks is not None
               else np.zeros((0, 0), np.int32)),
        meta=json.dumps(meta))
    os.replace(tmp, path)


def _load_v2(path: str, validate: bool, dev) -> SlingIndex:
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    version = meta.pop("_format_version", 1)
    if version > FORMAT_VERSION:
        raise ValueError(
            f"index file is format v{version}, this build reads "
            f"<= v{FORMAT_VERSION} (see INDEX_FORMAT.md)")
    stale = meta.pop("_stale", 0.0)
    epoch = meta.pop("_epoch", 0)
    plan = _parse_plan(meta)
    keys, vals, counts, d = z["keys"], z["vals"], z["counts"], z["d"]
    n, width = keys.shape
    _check_shapes(n, width, d, vals, counts)
    if validate:
        _validate_packed(plan, n, width, keys, counts)
    hp = HPTable(n=n, width=width, keys=torch.from_numpy(keys).to(dev),
                 vals=torch.from_numpy(vals).to(dev),
                 counts=torch.from_numpy(counts).to(dev), theta=plan.theta,
                 sqrt_c=plan.sqrt_c, l_max=plan.l_max)
    reduced = z["reduced"] if z["reduced"].size else None
    marks = z["marks"] if z["marks"].size else None
    return SlingIndex(plan=plan, d=torch.from_numpy(d).to(dev), hp=hp,
                      reduced=reduced, marks=marks, stale=stale,
                      epoch=epoch)


# ----------------------------------------------------------------------
# format v3: magic + version + JSON header + aligned raw arrays
#
#   bytes [0, 8)    : b"SLINGIDX"
#   bytes [8, 12)   : uint32 LE format version
#   bytes [12, 16)  : uint32 LE header JSON length H
#   bytes [16, 16+H): header JSON (utf-8)
#   data section    : starts at align64(16 + H); each array begins at
#                     data_start + arrays[name]["offset"] (64-byte
#                     aligned offsets relative to the data section)
# ----------------------------------------------------------------------
def _align64(x: int) -> int:
    return (x + _V3_ALIGN - 1) & ~(_V3_ALIGN - 1)


def _dtype_str(dt) -> str:
    return _BF16 if isinstance(dt, str) and dt == _BF16 \
        else np.dtype(dt).str


def _storage_dtype(s: str) -> np.dtype:
    """The NumPy dtype a member's bytes are read and written as."""
    return np.dtype(np.int16) if s == _BF16 else np.dtype(s)


class V3Writer:
    """Incremental format-v3 writer: declare the array table up front,
    fill members through ``array()`` memmap views, then ``finalize()``
    -- which fsyncs and atomically renames the tmp file into place.
    ``abort()`` (or a crash) leaves no torn artifact at the path."""

    def __init__(self, path: str, plan: theory.SlingPlan,
                 specs: dict[str, tuple], stale: float = 0.0,
                 epoch: int = 0, quant: QuantInfo | None = None,
                 builder: str = "sling", uncertified_d: bool = False):
        self.path = path = os.fspath(path)
        self.tmp = path + ".tmp"
        if builder not in KNOWN_BUILDERS:
            raise ValueError(f"unknown builder {builder!r}; this build "
                             f"writes {KNOWN_BUILDERS} (INDEX_FORMAT.md)")
        arrays = {}
        off = 0
        for name, (dt, shape) in specs.items():
            if name not in _V3_MEMBERS:
                raise ValueError(f"unknown v3 array member {name!r}")
            s = _dtype_str(dt)
            nbytes = int(np.prod(shape, dtype=np.int64)
                         * _storage_dtype(s).itemsize)
            arrays[name] = {"dtype": s, "shape": [int(x) for x in shape],
                            "offset": off}
            off = _align64(off + nbytes)
        header = {
            "plan": dataclasses.asdict(plan),
            "stale": float(stale),
            "epoch": int(epoch),
            "quant": None if quant is None else quant.to_meta(),
            "builder": builder,
            "uncertified_d": bool(uncertified_d),
            "arrays": arrays,
        }
        blob = json.dumps(header).encode()
        self._data_start = _align64(16 + len(blob))
        self._specs = {k: (_storage_dtype(v["dtype"]), tuple(v["shape"]),
                           v["offset"]) for k, v in arrays.items()}
        with open(self.tmp, "wb") as f:
            f.write(struct.pack("<8sII", V3_MAGIC, FORMAT_VERSION,
                                len(blob)))
            f.write(blob)
            f.truncate(self._data_start + off)
        self._mm: dict[str, np.memmap] = {}

    def array(self, name: str) -> np.memmap:
        """Writable view of one member; every element must be written
        before finalize (the file is zero-filled underneath)."""
        if name not in self._mm:
            dt, shape, off = self._specs[name]
            self._mm[name] = np.memmap(
                self.tmp, dtype=dt, mode="r+",
                offset=self._data_start + off, shape=shape)
        return self._mm[name]

    def finalize(self) -> None:
        for mm in self._mm.values():
            mm.flush()
        self._mm.clear()
        fd = os.open(self.tmp, os.O_RDWR)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(self.tmp, self.path)

    def abort(self) -> None:
        self._mm.clear()
        if os.path.exists(self.tmp):
            os.remove(self.tmp)


def _save_v3(idx: SlingIndex, path: str) -> None:
    hp = idx.hp
    d_codes = idx.quant is not None and idx.quant.d_scale > 0
    specs = {
        "d": (np.int16 if d_codes else np.float32, (hp.n,)),
        "keys": (np.int32, (hp.n, hp.width)),
        "vals": (_FILE_DTYPES[hp.vals.dtype], (hp.n, hp.width)),
        "counts": (_FILE_DTYPES[hp.counts.dtype], (hp.n,)),
    }
    if idx.reduced is not None:
        specs["reduced"] = (np.bool_, idx.reduced.shape)
    if idx.marks is not None:
        specs["marks"] = (np.int32, idx.marks.shape)
    w = V3Writer(path, idx.plan, specs, stale=idx.stale,
                 epoch=idx.epoch, quant=idx.quant,
                 builder=idx.builder, uncertified_d=idx.uncertified_d)
    try:
        if d_codes:
            w.array("d")[:] = _host(quantization.quantize_d_codes(
                idx.d, idx.quant))
        else:
            w.array("d")[:] = _host(idx.d.to(torch.float32))
        w.array("keys")[:] = _host(hp.keys)
        w.array("vals")[:] = _host(hp.vals)
        w.array("counts")[:] = _host(hp.counts)
        if idx.reduced is not None:
            w.array("reduced")[:] = idx.reduced
        if idx.marks is not None:
            w.array("marks")[:] = idx.marks
        w.finalize()
    except BaseException:
        w.abort()
        raise


def pack_coo_to_v3(path: str, plan: theory.SlingPlan, d: np.ndarray,
                   src: np.ndarray, key: np.ndarray, val: np.ndarray,
                   n: int, quantize: str | None = None,
                   quantize_d: bool = True, row_chunk: int = 1 << 16,
                   builder: str = "sling",
                   uncertified_d: bool = False) -> dict:
    """Assemble packed HP rows from COO triples straight into a v3 file
    on the host: the scale path's twin of ``hp_index._pack_coo`` plus
    ``save``.

    The triples (the only O(entries) state) are sorted once by (row,
    key); rows are then packed ``row_chunk`` at a time and written
    through the :class:`V3Writer` memmaps, so the (n, width) keys and
    vals never exist whole, in host memory or on a card. ``quantize``
    ("int16" | "bf16") writes val codes under the plan's eps_quant
    reserve, certified as ``quantize.quantize_index`` does; int16 codes
    are ``np.round(v / np.float32(scale))`` on the host, as the
    reference computes them. The file equals the reference's byte for
    byte on the same triples and d. Returns build stats."""
    src = np.ascontiguousarray(src, np.int64)
    key = np.ascontiguousarray(key, np.int32)
    val = np.ascontiguousarray(val, np.float32)
    order = np.lexsort((key, src))
    src, key, val = src[order], key[order], val[order]
    counts = np.bincount(src, minlength=n).astype(np.int32)
    width = max(1, int(counts.max())) if counts.size else 1
    row_start = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=row_start[1:])

    quant = None
    vals_dt = np.dtype(np.float32)
    d = np.ascontiguousarray(d, np.float32)
    d_codes = None
    if quantize is not None:
        b_vals = theory.quant_vals_bound(plan, d_channel=quantize_d)
        vmax = torch.tensor([val.max() if val.size else 0.0],
                            dtype=torch.float32)
        _, scale = quantization.quantize_array(vmax, quantize, b_vals)
        d_scale = b_d = 0.0
        if quantize_d:
            b_d = theory.quant_d_bound(plan)
            codes, d_scale = quantization.quantize_array(
                torch.from_numpy(d), "int16", b_d)
            d_codes = codes.numpy()
        quant = QuantInfo(scheme=quantize, scale=scale, bound=b_vals,
                          d_scale=d_scale, d_bound=b_d)
        vals_dt = _FILE_DTYPES[quantization.vals_dtype(quant)]

    specs = {
        "d": (np.int16 if d_codes is not None else np.float32, (n,)),
        "keys": (np.int32, (n, width)),
        "vals": (vals_dt, (n, width)),
        "counts": (np.int32, (n,)),
    }
    w = V3Writer(path, plan, specs, quant=quant, builder=builder,
                 uncertified_d=uncertified_d)
    try:
        w.array("d")[:] = d_codes if d_codes is not None else d
        w.array("counts")[:] = counts
        keys_mm = w.array("keys")
        vals_mm = w.array("vals")
        for r0 in range(0, n, row_chunk):
            r1 = min(n, r0 + row_chunk)
            e0, e1 = int(row_start[r0]), int(row_start[r1])
            kk = np.full((r1 - r0, width), INT32_PAD_KEY, np.int32)
            vv = np.zeros((r1 - r0, width), np.float32)
            rows = src[e0:e1] - r0
            rank = np.arange(e0, e1, dtype=np.int64) - row_start[src[e0:e1]]
            kk[rows, rank] = key[e0:e1]
            vv[rows, rank] = val[e0:e1]
            keys_mm[r0:r1] = kk
            if quant is None:
                vals_mm[r0:r1] = vv
            elif quant.scheme == "int16":
                vals_mm[r0:r1] = np.round(
                    vv / np.float32(quant.scale)).astype(np.int16)
            else:       # bf16 bits, stored as int16
                vals_mm[r0:r1] = torch.from_numpy(vv).to(
                    torch.bfloat16).view(torch.int16).numpy()
        w.finalize()
    except BaseException:
        w.abort()
        raise
    return {"path": path, "n": int(n), "width": int(width),
            "entries": int(len(src)),
            "bytes": int(os.path.getsize(path)),
            "quant": None if quant is None else quant.scheme,
            "builder": builder, "uncertified_d": bool(uncertified_d)}


def _read_v3_header(path: str):
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        pre = f.read(16)
        if len(pre) < 16:
            raise ValueError(f"{path}: truncated v3 preamble")
        magic, version, hlen = struct.unpack("<8sII", pre)
        if magic != V3_MAGIC:
            raise ValueError(f"{path}: bad v3 magic")
        if version > FORMAT_VERSION:
            raise ValueError(
                f"index file is format v{version}, this build reads "
                f"<= v{FORMAT_VERSION} (see INDEX_FORMAT.md)")
        if 16 + hlen > size:
            raise ValueError(f"{path}: truncated v3 header")
        try:
            header = json.loads(f.read(hlen).decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: corrupt v3 header ({e})") from e
    unknown = {k for k in header
               if not k.startswith("_")} - _V3_HEADER_KEYS
    if unknown:
        raise ValueError(f"{path}: unknown v3 header fields "
                         f"{sorted(unknown)}; refusing to drop them "
                         "(INDEX_FORMAT.md)")
    return header, _align64(16 + hlen), size


def _load_v3(path: str, mmap: bool, validate: bool | None,
             dev) -> SlingIndex:
    header, data_start, size = _read_v3_header(path)
    plan = _parse_plan(dict(header.get("plan", {})))
    quant = (None if header.get("quant") is None
             else QuantInfo.from_meta(header["quant"]))
    # absent = "sling" (every pre-provenance artifact was a sling
    # build); unknown values are refused
    builder = str(header.get("builder", "sling"))
    if builder not in KNOWN_BUILDERS:
        raise ValueError(f"{path}: index built by unknown builder "
                         f"{builder!r}; this build serves "
                         f"{KNOWN_BUILDERS} (INDEX_FORMAT.md)")
    uncertified_d = bool(header.get("uncertified_d", False))
    arrays_meta = header.get("arrays", {})
    unknown = set(arrays_meta) - set(_V3_MEMBERS)
    if unknown:
        raise ValueError(f"{path}: unknown v3 array members "
                         f"{sorted(unknown)}; refusing to drop them "
                         "(INDEX_FORMAT.md)")
    for req in ("d", "keys", "vals", "counts"):
        if req not in arrays_meta:
            raise ValueError(f"{path}: v3 file is missing required "
                             f"array {req!r}")
    arrays: dict[str, np.ndarray] = {}
    for name, spec in arrays_meta.items():
        dt = _storage_dtype(spec["dtype"])
        shape = tuple(int(s) for s in spec["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        off = data_start + int(spec["offset"])
        if off + count * dt.itemsize > size:
            raise ValueError(f"{path}: array {name!r} extends past "
                             "end of file (truncated artifact)")
        if count == 0:
            arrays[name] = np.zeros(shape, dt)
        elif mmap:
            arrays[name] = np.memmap(path, dtype=dt, mode="r",
                                     offset=off, shape=shape)
        else:
            with open(path, "rb") as f:
                f.seek(off)
                arrays[name] = np.fromfile(f, dtype=dt,
                                           count=count).reshape(shape)
    n, width = arrays["keys"].shape
    d = _as_tensor(arrays["d"], arrays_meta["d"]["dtype"], dev)
    vals_str = arrays_meta["vals"]["dtype"]
    if quant is not None:
        want = _dtype_str(_FILE_DTYPES[quantization.vals_dtype(quant)])
        if vals_str != want:
            raise ValueError(f"{path}: quantized vals dtype {vals_str} "
                             f"does not match scheme {quant.scheme!r}")
        if quant.d_scale > 0:
            # the diagonal's codes dequantize at load (n * 4 bytes), so
            # every d consumer stays float32
            d = quantization.dequantize_array(d, "int16", quant.d_scale)
    _check_shapes(n, width, d, arrays["vals"], arrays["counts"])
    if validate is None:
        validate = not mmap
    if validate:
        _validate_packed(plan, n, width, np.asarray(arrays["keys"]),
                         np.asarray(arrays["counts"]))
    hp = HPTable(
        n=n, width=width,
        keys=_as_tensor(arrays["keys"], arrays_meta["keys"]["dtype"], dev),
        vals=_as_tensor(arrays["vals"], vals_str, dev),
        counts=_as_tensor(arrays["counts"], arrays_meta["counts"]["dtype"],
                          dev),
        theta=plan.theta, sqrt_c=plan.sqrt_c, l_max=plan.l_max)
    reduced = arrays.get("reduced")
    if reduced is not None and reduced.size == 0:
        reduced = None
    marks = arrays.get("marks")
    if marks is not None and marks.size == 0:
        marks = None
    return SlingIndex(plan=plan, d=d.to(torch.float32), hp=hp,
                      reduced=reduced, marks=marks,
                      stale=float(header.get("stale", 0.0)),
                      epoch=int(header.get("epoch", 0)), quant=quant,
                      builder=builder, uncertified_d=uncertified_d,
                      read_only=mmap)


def _pair_query_batch(keys, vals, d, us, vs, n: int) -> torch.Tensor:
    """Sorted-key join for a batch of pairs: keys (N, K) int32 ascending
    with PAD; us/vs (B,) int64. Returns (B,) float32. On duplicate keys
    in row v it takes the first match, as the reference does."""
    K = keys.shape[1]
    ku, xu = keys[us], vals[us]
    kv, xv = keys[vs], vals[vs]
    idx = torch.searchsorted(kv, ku).clamp_(max=K - 1)
    match = (kv.gather(1, idx) == ku) & (ku != INT32_PAD_KEY)
    dk = d[(ku.long() % n).clamp_(0, n - 1)]
    prod = xu * xv.gather(1, idx) * dk
    return torch.where(match, prod, 0.0).sum(dim=1)
