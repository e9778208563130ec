"""The port's index artifact held against the reference on identical
bytes (INDEX_FORMAT.md): artifacts the reference writes -- v3 float32,
int16, bf16, with the Section-5 sidecars, with prsim and uncertified
provenance, and v2 ``.npz`` -- load in the port eager and mapped with
every array equal bit for bit and serve within ``BACKEND_ATOL`` of the
reference's engine; the port's v3 files for the same indexes equal the
reference's byte for byte and load in it; every refusal of the format
holds in both packages on the same bytes; and the port refuses the
state the format makes read-only (quantized and mapped indexes in
``update_index``) and the space-reduced index in its batched paths."""
import dataclasses
import json
import os
import struct
import warnings

import numpy as np
import pytest
import torch

import oracle
from repro.core import build as rbuild
from repro.core import optimizations as ropt
from repro.core import quantize as rquant
from repro.core.index import SlingIndex as RIndex
from repro.graph import csr as rcsr
from repro.graph import generators as rgen
from repro.serve import EngineConfig as REngineConfig
from repro.serve import QueryEngine as RQueryEngine
from repro_torch import convert
from repro_torch.core import device_state as tdevice_state
from repro_torch.core import optimizations as topt
from repro_torch.core import quantize as tquant
from repro_torch.core import single_source as tss
from repro_torch.core import update as tupdate
from repro_torch.core.index import FORMAT_VERSION, V3Writer
from repro_torch.core.index import SlingIndex as TIndex
from repro_torch.graph import csr as tcsr
from repro_torch.serve import EngineConfig, QueryEngine

ATOL = oracle.BACKEND_ATOL
KINDS = ("fp32", "int16", "bf16", "sidecars", "prsim_uncertified", "v2")
SERVED = ("fp32", "int16", "bf16", "prsim_uncertified")


@pytest.fixture(scope="module")
def graphs():
    g = rgen.barabasi_albert(60, 3, seed=2, directed=False)
    return g, convert.graph_from_arrays(g.n, g.edge_src, g.edge_dst)


@pytest.fixture(scope="module")
def ref_indexes(graphs):
    """The reference's indexes of each kind, as it builds them."""
    g, _ = graphs
    base = rbuild.build_index(g, eps=0.1, exact_d=True, seed=0,
                              quant_frac=0.25)
    # bf16 certifies only at a looser plan: vmax = 1 gives 2^-8 per
    # entry, above the eps = 0.1 bound
    wide = rbuild.build_index(g, eps=0.2, exact_d=True, seed=0,
                              quant_frac=0.8)
    side = rbuild.build_index(g, eps=0.1, exact_d=True, seed=0)
    plain = rbuild.build_index(g, eps=0.1, exact_d=True, seed=0)
    ropt.apply_space_reduction(side, g)
    ropt.mark_for_enhancement(side, g)
    prsim = rbuild.build_index(g, eps=0.1, exact_d=True, seed=0,
                               quant_frac=0.25, builder="prsim")
    return {"fp32": base, "int16": rquant.quantize_index(base, "int16"),
            "bf16": rquant.quantize_index(wide, "bf16", quantize_d=False),
            "bf16_base": wide, "sidecars": side, "plain": plain,
            "prsim_uncertified": dataclasses.replace(prsim,
                                                     uncertified_d=True),
            "v2": plain}


@pytest.fixture(scope="module")
def ref_files(ref_indexes, tmp_path_factory):
    """{kind: path} of the reference-written artifacts."""
    root = tmp_path_factory.mktemp("ref_artifacts")
    out = {}
    for kind in KINDS:
        p = str(root / (kind + (".npz" if kind == "v2" else ".sling")))
        ref_indexes[kind].save(p, version=2 if kind == "v2" else 3)
        out[kind] = p
    for kind in ("bf16_base", "plain"):
        out[kind] = str(root / f"{kind}.sling")
        ref_indexes[kind].save(out[kind])
    return out


def _raw(x) -> np.ndarray:
    """The bits of an array or tensor as integers (float32 as int32,
    bf16 as int16), so equality is bit for bit."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        x = x.cpu().numpy()
    x = np.asarray(x)
    if x.dtype.kind == "V" or x.dtype.name == "bfloat16":
        return x.view(np.int16)
    if x.dtype == np.float32:
        return x.view(np.int32)
    return x


def _assert_same_index(t: TIndex, r: RIndex) -> None:
    assert dataclasses.asdict(t.plan) == dataclasses.asdict(r.plan)
    assert (t.stale, t.epoch) == (r.stale, r.epoch)
    assert (t.builder, t.uncertified_d) == (r.builder, r.uncertified_d)
    assert (None if t.quant is None else t.quant.to_meta()) == \
        (None if r.quant is None else r.quant.to_meta())
    for a, b in ((t.d, r.d), (t.hp.keys, r.hp.keys),
                 (t.hp.vals, r.hp.vals), (t.hp.counts, r.hp.counts)):
        np.testing.assert_array_equal(_raw(a), _raw(b))
    for side in ("reduced", "marks"):
        x, y = getattr(t, side), getattr(r, side)
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _tload(path, **kw) -> TIndex:
    """The port's load on the CPU (eager) or mapped."""
    return TIndex.load(path, device=None if kw.get("mmap") else "cpu",
                       **kw)


def _rewrite_header(path, mutate):
    """Re-encode the header JSON of a v3 file after ``mutate(header)``,
    space-padded to keep the data section's alignment."""
    raw = open(path, "rb").read()
    magic, version, hlen = struct.unpack("<8sII", raw[:16])
    header = json.loads(raw[16:16 + hlen].decode())
    mutate(header)
    old_ds = (16 + hlen + 63) & ~63
    blob = json.dumps(header).encode()
    blob += b" " * (((16 + len(blob) + 63) & ~63) - 16 - len(blob))
    with open(path, "wb") as f:
        f.write(struct.pack("<8sII", magic, version, len(blob)))
        f.write(blob)
        f.write(raw[old_ds:])


def _both_refuse(path, match, **kw) -> None:
    """Both packages refuse the same bytes with the same message."""
    with pytest.raises(ValueError, match=match):
        RIndex.load(path, **kw)
    with pytest.raises(ValueError, match=match):
        _tload(path, **kw)


# ----------------------------------------------------------------------
# reference artifacts in the port
# ----------------------------------------------------------------------
def _member_offset(path, name) -> int:
    raw = open(path, "rb").read()
    _, _, hlen = struct.unpack("<8sII", raw[:16])
    header = json.loads(raw[16:16 + hlen].decode())
    return ((16 + hlen + 63) & ~63) + header["arrays"][name]["offset"]


@pytest.mark.parametrize("mmap", [False, True], ids=["eager", "mmap"])
@pytest.mark.parametrize("kind", KINDS)
def test_reference_artifacts_load_in_the_port(ref_files, ref_indexes,
                                              tmp_path, kind, mmap):
    if kind == "v2" and mmap:
        with pytest.raises(ValueError, match="memory-mapped"):
            _tload(ref_files[kind], mmap=True)
        return
    p = str(tmp_path / os.path.basename(ref_files[kind]))
    open(p, "wb").write(open(ref_files[kind], "rb").read())
    got = _tload(p, mmap=mmap)
    _assert_same_index(got, RIndex.load(p))
    _assert_same_index(got, ref_indexes[kind])
    assert got.read_only == mmap
    assert got.device.type == "cpu"
    if mmap:
        # zero-copy: a write to the file shows through the mapped pages
        key0 = int(got.hp.keys[0, 0])
        with open(p, "r+b") as f:
            f.seek(_member_offset(p, "keys"))
            f.write(struct.pack("<i", key0 + 1))
        assert int(got.hp.keys[0, 0]) == key0 + 1


@pytest.mark.parametrize("kind", SERVED)
def test_port_engine_matches_reference_engine_on_identical_bytes(
        graphs, ref_files, kind):
    """The reference's engine on its own load and the port's engine on
    the mapped file: pair, single-source and top-k within BACKEND_ATOL."""
    g, tg = graphs
    allow = kind == "prsim_uncertified"
    reng = RQueryEngine(RIndex.load(ref_files[kind]), g, REngineConfig(
        source_batch=4, pair_batch=32, cache_size=0,
        allow_uncertified=allow))
    teng = QueryEngine.from_index_file(
        ref_files[kind], tg, EngineConfig(source_batch=4, pair_batch=32,
                                          cache_size=0,
                                          allow_uncertified=allow),
        mmap=True, device="cpu")
    assert teng.stats()["quantized"] == reng.stats()["quantized"]
    rng = np.random.default_rng(3)
    us = rng.integers(0, g.n, 48).astype(np.int32)
    vs = rng.integers(0, g.n, 48).astype(np.int32)
    np.testing.assert_allclose(teng.pairs(us, vs), reng.pairs(us, vs),
                               atol=ATOL, rtol=0)
    q = us[:8]
    np.testing.assert_allclose(teng.single_source(q),
                               np.asarray(reng.single_source(q)),
                               atol=ATOL, rtol=0)
    tv, ti = teng.topk(q, 10)
    rv, _ = reng.topk(q, 10)
    np.testing.assert_allclose(tv, np.asarray(rv), atol=ATOL, rtol=0)
    full = teng.single_source(q)
    np.testing.assert_allclose(full[np.arange(len(q))[:, None], ti], tv,
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_host_pairs_match_reference_on_identical_bytes(graphs, ref_files,
                                                       kind):
    """``query_pair_host(u, v, g)``: dequantized, reduced rows
    re-materialized and enhanced exactly as the reference does."""
    g, tg = graphs
    r = RIndex.load(ref_files[kind])
    t = _tload(ref_files[kind], mmap=kind != "v2")
    rng = np.random.default_rng(5)
    for u, v in rng.integers(0, g.n, (40, 2)).tolist():
        assert t.query_pair_host(u, v, tg) == pytest.approx(
            r.query_pair_host(u, v, g), abs=ATOL)


# ----------------------------------------------------------------------
# port artifacts in the reference
# ----------------------------------------------------------------------
def _port_made(kind, ref_files, graphs) -> TIndex:
    """The port's own index of ``kind``: loaded from the reference's
    float32 artifact, then quantized or reduced by the port."""
    _, tg = graphs
    if kind == "int16":
        return tquant.quantize_index(_tload(ref_files["fp32"]), "int16")
    if kind == "bf16":
        return tquant.quantize_index(_tload(ref_files["bf16_base"]),
                                     "bf16", quantize_d=False)
    if kind == "sidecars":
        t = _tload(ref_files["plain"])
        topt.apply_space_reduction(t, tg)
        topt.mark_for_enhancement(t, tg)
        return t
    return _tload(ref_files[kind])


@pytest.mark.parametrize("kind", KINDS[:-1])
def test_port_artifacts_are_byte_identical_and_load_in_reference(
        graphs, ref_files, tmp_path, kind):
    t = _port_made(kind, ref_files, graphs)
    p = str(tmp_path / "port.sling")
    t.save(p)
    assert open(p, "rb").read() == open(ref_files[kind], "rb").read()
    for mmap in (False, True):
        _assert_same_index(t, RIndex.load(p, mmap=mmap))


@pytest.mark.parametrize("name", tuple(oracle.cases()))
def test_port_quantized_and_reduced_files_equal_reference_on_zoo(
        tmp_path, name):
    """On every zoo graph the port re-derives the reference's int16 and
    space-reduced, enhanced artifacts from its float32 file byte for
    byte."""
    g = oracle.cases()[name]
    tg = convert.graph_from_arrays(g.n, g.edge_src, g.edge_dst)
    ri = rbuild.build_index(g, eps=0.1, exact_d=True, quant_frac=0.25)
    base = str(tmp_path / "base.sling")
    ri.save(base)
    # the quantized index shares keys with ri: save it before reducing
    rquant.quantize_index(ri, "int16").save(str(tmp_path / "rq.sling"))
    tquant.quantize_index(_tload(base), "int16").save(
        str(tmp_path / "tq.sling"))
    ropt.apply_space_reduction(ri, g)
    ropt.mark_for_enhancement(ri, g)
    ri.save(str(tmp_path / "rs.sling"))
    ts = _tload(base)
    topt.apply_space_reduction(ts, tg)
    topt.mark_for_enhancement(ts, tg)
    ts.save(str(tmp_path / "ts.sling"))
    for kind in ("q", "s"):
        assert open(tmp_path / f"t{kind}.sling", "rb").read() == \
            open(tmp_path / f"r{kind}.sling", "rb").read()


def test_port_v2_loads_in_reference(ref_files, ref_indexes, tmp_path):
    t = _tload(ref_files["v2"])
    p = str(tmp_path / "port.npz")
    t.save(p, version=2)
    assert open(p, "rb").read(2) == b"PK"
    got = RIndex.load(p)
    _assert_same_index(t, got)
    _assert_same_index(_tload(p), ref_indexes["v2"])


# ----------------------------------------------------------------------
# refusals (INDEX_FORMAT.md), in both packages on the same bytes
# ----------------------------------------------------------------------
@pytest.fixture()
def fp32_file(ref_files, tmp_path):
    p = str(tmp_path / "idx.sling")
    _tload(ref_files["fp32"]).save(p)
    return p


def test_v2_refuses_quantized(ref_files, tmp_path):
    t = _tload(ref_files["int16"])
    with pytest.raises(ValueError, match="v2 cannot carry"):
        t.save(str(tmp_path / "q.npz"), version=2)


def test_refuses_future_version(fp32_file):
    raw = bytearray(open(fp32_file, "rb").read())
    raw[8:12] = struct.pack("<I", FORMAT_VERSION + 1)
    open(fp32_file, "wb").write(bytes(raw))
    _both_refuse(fp32_file, f"format v{FORMAT_VERSION + 1}")


def test_refuses_future_v2_version(ref_files, tmp_path):
    z = dict(np.load(ref_files["v2"]))
    meta = json.loads(str(z["meta"]))
    meta["_format_version"] = FORMAT_VERSION + 1
    z["meta"] = json.dumps(meta)
    p = str(tmp_path / "future.npz")
    np.savez(p, **z)
    _both_refuse(p, f"format v{FORMAT_VERSION + 1}")


def test_refuses_unknown_header_field(fp32_file):
    _rewrite_header(fp32_file, lambda h: h.update(compression="zstd"))
    _both_refuse(fp32_file, "unknown v3 header fields")
    # underscore-prefixed metadata is additive and must not refuse
    _rewrite_header(fp32_file, lambda h: (h.pop("compression"),
                                          h.update(_created_at="x")))
    _tload(fp32_file, validate=False)
    RIndex.load(fp32_file, validate=False)


def test_refuses_unknown_plan_field(fp32_file):
    _rewrite_header(fp32_file, lambda h: h["plan"].update(gamma=2.0))
    _both_refuse(fp32_file, "unknown fields")


def test_refuses_unknown_array_member(fp32_file):
    _rewrite_header(fp32_file, lambda h: h["arrays"].update(
        huffman={"dtype": "<u1", "shape": [8], "offset": 0}))
    _both_refuse(fp32_file, "unknown v3 array members")


def test_refuses_missing_required_array(fp32_file):
    _rewrite_header(fp32_file, lambda h: h["arrays"].pop("counts"))
    _both_refuse(fp32_file, "missing required array 'counts'")


def test_refuses_unknown_quant_field(ref_files, tmp_path):
    p = str(tmp_path / "quant.sling")
    _tload(ref_files["int16"]).save(p)
    _rewrite_header(p, lambda h: h["quant"].update(dither="tpdf"))
    _both_refuse(p, "unknown quantization metadata")


def test_refuses_quantized_vals_dtype_mismatch(ref_files, tmp_path):
    p = str(tmp_path / "scheme.sling")
    _tload(ref_files["int16"]).save(p)
    _rewrite_header(p, lambda h: h["quant"].update(scheme="bf16"))
    _both_refuse(p, "does not match scheme 'bf16'")


def test_refuses_truncated_artifacts(fp32_file):
    raw = open(fp32_file, "rb").read()
    open(fp32_file, "wb").write(raw[:8])
    _both_refuse(fp32_file, "truncated v3 preamble")
    open(fp32_file, "wb").write(raw[:20])
    _both_refuse(fp32_file, "truncated v3 header")
    open(fp32_file, "wb").write(raw[: len(raw) - 97])
    _both_refuse(fp32_file, "truncated artifact")
    _both_refuse(fp32_file, "truncated artifact", mmap=True)


def test_refuses_corrupt_header_json(fp32_file):
    raw = bytearray(open(fp32_file, "rb").read())
    _, _, hlen = struct.unpack("<8sII", raw[:16])
    raw[16:16 + hlen] = b"\xff" * hlen
    open(fp32_file, "wb").write(bytes(raw))
    _both_refuse(fp32_file, "corrupt v3 header")


def test_refuses_bad_magic(tmp_path):
    p = str(tmp_path / "junk.bin")
    open(p, "wb").write(b"GARBAGE!" + b"\x00" * 64)
    _both_refuse(p, "not a SLING index artifact")


def test_refuses_corrupt_packed_rows(fp32_file, ref_indexes):
    """Eager loads scan the packed-row invariants; mapped loads skip
    the scan unless asked."""
    raw = bytearray(open(fp32_file, "rb").read())
    off = _member_offset(fp32_file, "counts")
    raw[off:off + 4] = struct.pack("<i", ref_indexes["fp32"].hp.width + 5)
    open(fp32_file, "wb").write(bytes(raw))
    _both_refuse(fp32_file, "INDEX_FORMAT.md invariants")
    _tload(fp32_file, mmap=True)
    _both_refuse(fp32_file, "INDEX_FORMAT.md invariants", mmap=True,
                 validate=True)


@pytest.mark.parametrize("which", ["key_order", "key_range"])
def test_refuses_bad_live_keys(fp32_file, which):
    raw = bytearray(open(fp32_file, "rb").read())
    off = _member_offset(fp32_file, "keys")
    first = struct.unpack("<i", raw[off:off + 4])[0]
    bad = first + 10 ** 6 if which == "key_order" else -1
    raw[off:off + 4] = struct.pack("<i", bad)
    open(fp32_file, "wb").write(bytes(raw))
    _both_refuse(fp32_file, "INDEX_FORMAT.md invariants")


def test_refuses_mmap_of_v2(ref_files):
    _both_refuse(ref_files["v2"], "memory-mapped", mmap=True)


def test_refuses_unknown_write_version_and_writer_fields(ref_files,
                                                         tmp_path):
    t = _tload(ref_files["fp32"])
    with pytest.raises(ValueError, match="cannot write format v4"):
        t.save(str(tmp_path / "x"), version=4)
    with pytest.raises(ValueError, match="unknown builder 'mystery'"):
        V3Writer(str(tmp_path / "w"), t.plan, {}, builder="mystery")
    with pytest.raises(ValueError, match="unknown v3 array member"):
        V3Writer(str(tmp_path / "w"), t.plan,
                 {"huffman": (np.uint8, (8,))})
    assert not os.path.exists(str(tmp_path / "x"))


# ----------------------------------------------------------------------
# atomicity
# ----------------------------------------------------------------------
def test_save_is_atomic_under_crash(ref_files, tmp_path, monkeypatch):
    t = _tload(ref_files["fp32"])
    p = str(tmp_path / "atomic.sling")
    t.save(p)
    before = open(p, "rb").read()

    def boom(src, dst):
        raise OSError("simulated crash before rename")

    for version in (3, 2):
        monkeypatch.setattr(os, "replace", boom)
        with pytest.raises(OSError, match="simulated crash"):
            t.save(p, version=version)
        monkeypatch.undo()
        assert open(p, "rb").read() == before
    # v3 cleans its tmp file up; nothing torn is left at the path
    assert [f for f in os.listdir(tmp_path)
            if ".tmp" in f and not f.endswith(".npz")] == []
    _assert_same_index(_tload(p), RIndex.load(ref_files["fp32"]))


def test_save_leaves_no_tmp_on_success(ref_files, tmp_path):
    t = _tload(ref_files["int16"])
    t.save(str(tmp_path / "ok.sling"))
    t2 = _tload(ref_files["v2"])
    t2.save(str(tmp_path / "ok.npz"), version=2)
    assert sorted(os.listdir(tmp_path)) == ["ok.npz", "ok.sling"]


# ----------------------------------------------------------------------
# builder provenance and the uncertified flag
# ----------------------------------------------------------------------
def test_v2_refuses_builder_metadata(ref_files, tmp_path):
    t = _tload(ref_files["prsim_uncertified"])
    with pytest.raises(ValueError, match="no builder/uncertified_d"):
        t.save(str(tmp_path / "p.npz"), version=2)
    t.uncertified_d = False
    with pytest.raises(ValueError, match="no builder/uncertified_d"):
        t.save(str(tmp_path / "p.npz"), version=2)


def test_refuses_unknown_builder(fp32_file):
    _rewrite_header(fp32_file, lambda h: h.update(builder="mystery"))
    _both_refuse(fp32_file, "unknown builder 'mystery'")
    # absent builder = "sling" (every pre-provenance artifact)
    _rewrite_header(fp32_file, lambda h: h.pop("builder"))
    assert _tload(fp32_file, validate=False).builder == "sling"


def test_uncertified_flag_roundtrips_and_engine_refuses(graphs,
                                                        fp32_file):
    _, tg = graphs
    good = _tload(fp32_file)
    _rewrite_header(fp32_file, lambda h: h.update(uncertified_d=True))
    for mmap in (False, True):
        got = _tload(fp32_file, mmap=mmap, validate=False)
        assert got.uncertified_d
        with pytest.raises(ValueError, match="uncertified"):
            QueryEngine(got, tg, device="cpu")
        with pytest.raises(ValueError, match="uncertified"):
            QueryEngine.from_index_file(fp32_file, tg, mmap=mmap,
                                        device="cpu")
    eng = QueryEngine(got, tg, EngineConfig(allow_uncertified=True),
                      device="cpu")
    assert 0.0 <= eng.pair(0, 1) <= 1.0
    eng2 = QueryEngine(good, tg, device="cpu")
    with pytest.raises(ValueError, match="hot-swap"):
        eng2.swap_index(got, tg)


# ----------------------------------------------------------------------
# where the data lives, and the state the format makes read-only
# ----------------------------------------------------------------------
def test_mapped_load_is_read_only_without_warning(ref_files):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t = _tload(ref_files["bf16"], mmap=True)
    assert t.read_only and t.hp.vals.dtype == torch.bfloat16
    assert _tload(ref_files["bf16"]).read_only is False


def test_entry_points_default_to_the_card(graphs, ref_files, monkeypatch):
    """An eager load, the engine over a mapped file, the one-shot paths
    and the batched pair join run on cuda unless asked for the CPU, even
    when the storage is host memory; a mapped load refuses a card
    device. Without a card they raise instead of taking the CPU."""
    _, tg = graphs
    mapped = _tload(ref_files["fp32"], mmap=True)
    with pytest.raises(ValueError, match="mmap=True maps the file"):
        TIndex.load(ref_files["fp32"], mmap=True, device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
            lambda: TIndex.load(ref_files["fp32"]),
            lambda: QueryEngine.from_index_file(ref_files["fp32"], tg,
                                                mmap=True),
            lambda: tdevice_state.serving_arrays(mapped, tg),
            lambda: tss.single_source_device(mapped, tg, [0]),
            lambda: mapped.query_pairs([0], [1])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def _delta():
    return tcsr.GraphDelta(add_src=np.array([0]), add_dst=np.array([5]),
                           del_src=np.zeros(0, np.int64),
                           del_dst=np.zeros(0, np.int64))


@pytest.mark.parametrize("kind", ["int16", "bf16", "mapped"])
def test_update_refuses_quantized_and_mapped_unchanged(graphs, ref_files,
                                                       kind):
    """``update_index`` refuses before it writes anything: the index's
    bytes, stale and epoch stay as they were."""
    _, tg = graphs
    t = _tload(ref_files["fp32" if kind == "mapped" else kind],
               mmap=kind == "mapped")
    before = [_raw(x).copy() for x in (t.d, t.hp.keys, t.hp.vals,
                                       t.hp.counts)]
    with pytest.raises(ValueError, match="read-only"):
        tupdate.update_index(t, tg, _delta())
    after = [_raw(x) for x in (t.d, t.hp.keys, t.hp.vals, t.hp.counts)]
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a, b)
    assert (t.stale, t.epoch) == (0.0, 0)
    if kind == "mapped":
        with pytest.raises(ValueError, match="read-only"):
            topt.apply_space_reduction(t, tg)


def test_batched_paths_refuse_a_reduced_index(graphs, ref_files):
    """The reference's engine serves a space-reduced index without the
    dropped step-1/2 entries; the port refuses it in every batched path
    and answers through the host path."""
    g, tg = graphs
    t = _tload(ref_files["sidecars"], mmap=True)
    assert t.reduced.any()
    for call in (lambda: QueryEngine(t, tg, device="cpu"),
                 lambda: QueryEngine.from_index_file(
                     ref_files["sidecars"], tg, mmap=True, device="cpu"),
                 lambda: tdevice_state.serving_arrays(t, tg, "cpu"),
                 lambda: t.query_pairs([0], [1], device="cpu")):
        with pytest.raises(ValueError, match="space-reduced"):
            call()
    eng = QueryEngine(_tload(ref_files["plain"]), tg, device="cpu")
    with pytest.raises(ValueError, match="space-reduced"):
        eng.swap_index(t, tg)
    with pytest.raises(ValueError, match="pass g"):
        t.query_pair_host(0, 1)
    r = RIndex.load(ref_files["sidecars"])
    assert t.query_pair_host(0, 1, tg) == pytest.approx(
        r.query_pair_host(0, 1, g), abs=ATOL)


def test_update_clears_marks_of_repaired_rows(graphs, ref_files):
    """``marks[rows] = -1`` on the rows the batch repaired, as the
    reference does; the other rows keep theirs."""
    g, tg = graphs
    r = RIndex.load(ref_files["plain"])
    ropt.mark_for_enhancement(r, g)
    t = _tload(ref_files["plain"])
    topt.mark_for_enhancement(t, tg)
    np.testing.assert_array_equal(t.marks, r.marks)
    delta = rcsr.GraphDelta(add_src=np.array([0, 7]),
                            add_dst=np.array([5, 9]),
                            del_src=np.zeros(0, np.int64),
                            del_dst=np.zeros(0, np.int64))
    from repro.core import update as rupdate
    rrep = rupdate.update_index(r, g, delta, exact_d=True)
    trep = tupdate.update_index(t, tg, tcsr.GraphDelta(
        add_src=delta.add_src, add_dst=delta.add_dst,
        del_src=delta.del_src, del_dst=delta.del_dst), exact_d=True)
    assert trep.rows_repaired == rrep.rows_repaired > 0
    cleared = np.all(t.marks == -1, axis=1)
    assert cleared.sum() >= trep.rows_repaired
    np.testing.assert_array_equal(t.marks, r.marks)


# ----------------------------------------------------------------------
# the serving CLI's artifact flags
# ----------------------------------------------------------------------
def test_serve_cli_saves_then_serves_the_mapped_quantized_file(tmp_path,
                                                               capsys):
    from repro_torch.launch import serve
    p = str(tmp_path / "t.sling")
    base = ["--device", "cpu", "--n", "200", "--queries", "8", "--mode",
            "mixed"]
    serve.main(base + ["--quantize", "int16", "--quant-frac", "0.25",
                       "--save-index", p])
    built = capsys.readouterr().out
    serve.main(base + ["--index", p, "--mmap"])
    loaded = capsys.readouterr().out
    assert "index quantized (int16)" in built and "mmap, int16" in loaded
    for out in (built, loaded):
        assert "(fixed shape set OK)" in out

    def samples(out):
        return [ln for ln in out.splitlines() if "] sample:" in ln]
    assert len(samples(built)) == 3 and samples(built) == samples(loaded)


@pytest.mark.parametrize("argv, match", [
    (["--quantize", "int16"], "--quantize needs --quant-frac > 0"),
    (["--mutate", "1", "--quantize", "bf16", "--quant-frac", "0.5"],
     "--mutate needs a writable fp32 index"),
    (["--mutate", "1", "--mmap"], "--mutate needs a writable fp32 index")])
def test_serve_cli_refuses_bad_artifact_flags(argv, match, capsys):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit) as e:
        serve.main(["--device", "cpu"] + argv)
    assert e.value.code == 2
    assert match in capsys.readouterr().err
