"""The port's million-node scale path held against the JAX reference on
the oracle zoo, on the CPU: ``generators.powerlaw_fast``,
``graph/stats.py``'s builder choice, the sparse-frontier HP build, the
build options (``_CooSink`` spill files, ``width=``,
``pad_packed_rows``), the chunked certified diagonal, the degree
diagonal, the streaming ``pack_coo_to_v3`` (a file equal byte for byte
to the reference's on the same triples), ``build_index`` with the
reference's positional order through ``builder``, the refusals, and a
``build_index_scale`` file served within the planned eps of exact
SimRank. Last, the port's twin of the reference's 10^5-node scale smoke
under the same peak-RSS gate (``scale`` and ``slow``)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import oracle
from repro.core import build as rbuild
from repro.core import diagonal as rdiagonal
from repro.core import hp_index as rhp
from repro.core import theory as rtheory
from repro.core.index import SlingIndex as RIndex
from repro.core.index import pack_coo_to_v3 as rpack
from repro.graph import generators as rgen
from repro.graph import stats as rstats
from repro_torch import convert
from repro_torch.core import build as tbuild
from repro_torch.core import diagonal as tdiagonal
from repro_torch.core import hp_index as thp
from repro_torch.core import theory as ttheory
from repro_torch.core.index import SlingIndex as TIndex
from repro_torch.core.index import pack_coo_to_v3 as tpack
from repro_torch.graph import generators as tgen
from repro_torch.graph import stats as tstats
from repro_torch.serve import EngineConfig, QueryEngine

ZOO = tuple(oracle.cases())
CSR_FIELDS = ("in_ptr", "in_idx", "out_ptr", "out_idx", "edge_dst",
              "edge_src")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The ops here are tiny and dispatch-bound: one intra-op thread
    keeps them from contending with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _graphs(name):
    r = oracle.cases()[name]
    return r, convert.graph_from_arrays(r.n, r.edge_src, r.edge_dst)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ----------------------------------------------------------------------
# the generator and the builder choice
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n, k, alpha, seed", [
    (400, 6, 2.2, 0), (1000, 3, 1.5, 7), (64, 6, 3.0, 2)])
def test_powerlaw_fast_equals_reference(n, k, alpha, seed):
    r = rgen.powerlaw_fast(n, k=k, alpha=alpha, seed=seed)
    t = tgen.powerlaw_fast(n, k=k, alpha=alpha, seed=seed)
    assert (t.n, t.m) == (r.n, r.m)
    for f in CSR_FIELDS:
        np.testing.assert_array_equal(getattr(t, f), getattr(r, f))
    with pytest.raises(ValueError, match="alpha"):
        tgen.powerlaw_fast(n, alpha=1.0)


SKEW_GRAPHS = {
    **{name: (lambda name=name: oracle.cases()[name]) for name in ZOO},
    "powerlaw_fast-400": lambda: rgen.powerlaw_fast(400, seed=0),
    "erdos_renyi-400": lambda: rgen.erdos_renyi(400, 1600, seed=0),
}


@pytest.mark.parametrize("name", SKEW_GRAPHS)
def test_measure_skew_and_choice_equal_reference(name):
    r = SKEW_GRAPHS[name]()
    t = convert.graph_from_arrays(r.n, r.edge_src, r.edge_dst)
    assert tstats.measure_skew(t).as_row() == rstats.measure_skew(r).as_row()
    (tb, ts), (rb, rs) = tstats.choose_builder(t), rstats.choose_builder(r)
    assert tb == rb and ts.as_row() == rs.as_row()
    assert tbuild.resolve_builder(t, "auto")[0] == tb
    if name == "powerlaw_fast-400":     # bench_preprocess.py's contract
        assert tb == "prsim"
    if name == "erdos_renyi-400":
        assert tb == "sling"


def test_hill_alpha_and_top_mass_edge_cases_equal_reference():
    for deg in (np.zeros(5), np.ones(20), np.arange(30), np.array([7] * 9)):
        assert tstats.hill_alpha(deg) == rstats.hill_alpha(deg)
        assert tstats.top_mass(deg) == rstats.top_mass(deg)
    assert tstats.top_mass(np.zeros(0)) == (0.0, 0.0)


# ----------------------------------------------------------------------
# the sparse build and the build options
# ----------------------------------------------------------------------
@pytest.mark.parametrize("eps", [0.1, 0.05])
@pytest.mark.parametrize("name", ZOO)
def test_sparse_build_matches_reference(name, eps):
    r, t = _graphs(name)
    p = rtheory.plan(eps=eps, c=0.6, n=r.n)
    ref = rhp.build_hp_table_sparse(r, p.theta, p.sqrt_c, p.l_max,
                                    block=16)
    got = thp.build_hp_table_sparse(t, p.theta, p.sqrt_c, p.l_max,
                                    block=16, device="cpu")
    assert got.width == ref.width
    np.testing.assert_array_equal(got.counts.numpy(), ref.counts)
    np.testing.assert_array_equal(got.keys.numpy(), ref.keys)
    np.testing.assert_allclose(got.vals.numpy(), ref.vals, atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("name", ZOO)
def test_sparse_build_matches_dense(name):
    _, t = _graphs(name)
    p = ttheory.plan(eps=0.1, c=0.6, n=t.n)
    dense = thp.build_hp_table(t, p.theta, p.sqrt_c, p.l_max,
                               device="cpu")
    sparse = thp.build_hp_table_sparse(t, p.theta, p.sqrt_c, p.l_max,
                                       block=32, device="cpu")
    assert sparse.width == dense.width
    assert torch.equal(sparse.counts, dense.counts)
    assert torch.equal(sparse.keys, dense.keys)
    np.testing.assert_allclose(sparse.vals.numpy(), dense.vals.numpy(),
                               atol=1e-6, rtol=0)


def test_segment_sum_is_the_pairwise_tree():
    """Each segment sums as the fixed pairwise tree over its own
    positions, whatever its neighbours hold."""
    rng = np.random.default_rng(0)
    lens = np.array([1, 2, 3, 7, 8, 9, 33])
    x = rng.random(lens.sum())
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])

    def tree(a):
        a = list(a)
        s = 1
        while s < len(a):
            for r in range(0, len(a), 2 * s):
                if r + s < len(a):
                    a[r] = a[r] + a[r + s]
            s *= 2
        return a[0]

    got = thp._segment_sum(torch.as_tensor(x), torch.as_tensor(starts),
                           torch.as_tensor(lens), int(lens.max())).numpy()
    want = [tree(x[s:s + n]) for s, n in zip(starts, lens)]
    np.testing.assert_array_equal(got, want)


def test_coo_sink_spill_equals_in_memory(tmp_path):
    _, t = _graphs("powerlaw")
    p = ttheory.plan(eps=0.1, c=0.6, n=t.n)
    mem, spill = thp._CooSink(None), thp._CooSink(str(tmp_path), tag="t")
    for sink in (mem, spill):
        thp.sparse_hp_coo(t, p.theta, p.sqrt_c, p.l_max, 16, sink,
                          device="cpu")
        sink.add(10**6, np.zeros(0, np.int32), np.zeros(0, np.int32),
                 np.zeros(0, np.float32))          # empty: no file
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"t_{b0}.npz" for b0 in range(0, t.n, 16))
    for a, b in zip(mem.collect(), spill.collect()):
        assert a.dtype == b.dtype and torch.equal(a, b)
    dense = thp.build_hp_table(t, p.theta, p.sqrt_c, p.l_max, block=16,
                               device="cpu")
    spilled = thp.build_hp_table(t, p.theta, p.sqrt_c, p.l_max, block=16,
                                 spill_dir=str(tmp_path / "dense"),
                                 device="cpu")
    assert torch.equal(dense.keys, spilled.keys)
    assert torch.equal(dense.vals, spilled.vals)
    assert len(os.listdir(tmp_path / "dense")) == -(-t.n // 16)
    empty = thp._CooSink(str(tmp_path / "none")).collect()
    assert [x.numel() for x in empty] == [0, 0, 0]
    assert [x.dtype for x in empty] == [torch.int32, torch.int32,
                                        torch.float32]


@pytest.mark.parametrize("width", [None, 5, 300])
def test_build_hp_table_width_and_pad_packed_rows_equal_reference(width):
    r, t = _graphs("dag")
    p = rtheory.plan(eps=0.1, c=0.6, n=r.n)
    ref = rhp.build_hp_table(r, p.theta, p.sqrt_c, p.l_max, block=16,
                             width=width)
    got = thp.build_hp_table(t, p.theta, p.sqrt_c, p.l_max, block=16,
                             width=width, device="cpu")
    assert got.width == ref.width == max(width or 0, int(ref.counts.max()))
    np.testing.assert_array_equal(got.keys.numpy(), ref.keys)
    sparse = thp.build_hp_table_sparse(t, p.theta, p.sqrt_c, p.l_max,
                                       width=width, device="cpu")
    assert sparse.width == ref.width
    for n_pad, cap in ((r.n, ref.width), (r.n + 3, ref.width + 64)):
        rk, rv = rhp.pad_packed_rows(ref, n_pad, cap)
        tk, tv = thp.pad_packed_rows(got, n_pad, cap)
        np.testing.assert_array_equal(tk.numpy(), rk)
        np.testing.assert_allclose(tv.numpy(), rv, atol=1e-5, rtol=0)
        assert tk.dtype == torch.int32 and tv.dtype == torch.float32
    with pytest.raises(ValueError, match="caps below"):
        thp.pad_packed_rows(got, r.n, ref.width - 1)
    with pytest.raises(ValueError, match="caps below"):
        thp.pad_packed_rows(got, r.n - 1, ref.width)


# ----------------------------------------------------------------------
# the diagonals
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ("er", "powerlaw", "sinks"))
def test_chunked_diagonal_within_eps_d(name):
    _, t = _graphs(name)
    p = ttheory.plan(eps=0.1, c=0.6, n=t.n)
    got = tdiagonal.estimate_diagonal_chunked(t, p, seed=3, shard=16,
                                              device="cpu")
    exact = tdiagonal.exact_diagonal(t, 0.6)
    assert got.dtype == np.float32 and got.shape == (t.n,)
    assert np.abs(got - exact).max() <= p.eps_d
    # shard i draws from seed + i: the first shard is the subset pass
    first = tdiagonal.estimate_diagonal(
        t, p, seed=3, nodes=np.arange(16), d_init=np.ones(t.n, np.float32),
        device="cpu")
    np.testing.assert_array_equal(got[:16], first[:16])


@pytest.mark.parametrize("name", ZOO)
def test_approx_diagonal_degree_equals_reference(name):
    r, t = _graphs(name)
    got = tbuild.approx_diagonal_degree(t, 0.6)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, rbuild.approx_diagonal_degree(r, 0.6))


# ----------------------------------------------------------------------
# the streaming v3 pack
# ----------------------------------------------------------------------
@pytest.mark.parametrize("quantize, frac", [(None, 0.0), ("int16", 0.2),
                                            ("bf16", 0.9)])
def test_pack_coo_to_v3_file_equals_reference(tmp_path, quantize, frac):
    """The same numpy triples and d through both packages: equal bytes,
    and each package loads the other's file with equal arrays."""
    r, t = _graphs("powerlaw")
    eps = 0.5 if quantize == "bf16" else 0.1   # bf16 certifies loosely
    rp = rtheory.plan(eps=eps, c=0.6, n=r.n, eps_quant_frac=frac)
    tp = ttheory.plan(eps=eps, c=0.6, n=r.n, eps_quant_frac=frac)
    sink = rhp._CooSink(None)
    rhp.sparse_hp_coo(r, rp.theta, rp.sqrt_c, rp.l_max, 16, sink)
    src, key, val = sink.collect()
    d = rdiagonal.exact_diagonal(r, 0.6).astype(np.float32)
    rpath, tpath = str(tmp_path / "r.sling"), str(tmp_path / "t.sling")
    rs = rpack(rpath, rp, d, src, key, val, r.n, quantize=quantize,
               row_chunk=7, builder="prsim")
    ts = tpack(tpath, tp, d, src, key, val, r.n, quantize=quantize,
               row_chunk=7, builder="prsim")
    assert {k: v for k, v in ts.items() if k != "path"} == \
        {k: v for k, v in rs.items() if k != "path"}
    with open(rpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    for mmap in (False, True):
        got = TIndex.load(rpath, mmap=mmap, device="cpu")
        back = RIndex.load(tpath, mmap=mmap)
        assert got.builder == back.builder == "prsim"
        for x, y in ((got.hp.keys, back.hp.keys),
                     (got.hp.counts, back.hp.counts)):
            np.testing.assert_array_equal(_np(x), np.asarray(y))
        np.testing.assert_array_equal(got.vals_f32().numpy(),
                                      np.asarray(back.vals_f32()))
        np.testing.assert_array_equal(got.d.numpy(), np.asarray(back.d))


def test_pack_coo_to_v3_streams_rows_as_the_in_memory_pack(tmp_path):
    """Every row chunking gives the packed table ``_pack_coo`` gives."""
    _, t = _graphs("sinks")
    p = ttheory.plan(eps=0.1, c=0.6, n=t.n)
    table = thp.build_hp_table_sparse(t, p.theta, p.sqrt_c, p.l_max,
                                      device="cpu")
    sink = thp._CooSink(None)
    thp.sparse_hp_coo(t, p.theta, p.sqrt_c, p.l_max, 8, sink, device="cpu")
    src, key, val = (x.numpy() for x in sink.collect())
    d = np.ones(t.n, np.float32)
    for chunk in (1, 5, t.n, 1 << 16):
        path = str(tmp_path / f"c{chunk}.sling")
        tpack(path, p, d, src, key, val, t.n, row_chunk=chunk)
        got = TIndex.load(path, mmap=True)
        assert got.read_only and got.hp.width == table.width
        assert torch.equal(got.hp.keys, table.keys)
        assert torch.equal(got.hp.vals, table.vals)
        assert torch.equal(got.hp.counts, table.counts)


# ----------------------------------------------------------------------
# build_index and build_index_scale
# ----------------------------------------------------------------------
def test_build_index_takes_spill_dir_and_builder_by_position(tmp_path):
    r, t = _graphs("powerlaw")
    spill = str(tmp_path / "spill")
    got = tbuild.build_index(t, 0.1, None, 0.6, 0, True, 16, spill, False,
                             False, True, 0.0, 0.0, "prsim", device="cpu")
    assert got.builder == "prsim" and os.listdir(spill)
    ref = rbuild.build_index(r, 0.1, None, 0.6, 0, True, 16, None, False,
                             False, True, 0.0, 0.0, "prsim")
    np.testing.assert_array_equal(got.hp.keys.numpy(), ref.hp.keys)
    np.testing.assert_allclose(got.hp.vals.numpy(), ref.hp.vals,
                               atol=1e-6, rtol=0)
    sling = tbuild.build_index(t, 0.1, None, 0.6, 0, True, 16,
                               str(tmp_path / "s"), exact_d=True,
                               builder="sling", device="cpu")
    inmem = tbuild.build_index(t, 0.1, exact_d=True, block=16,
                               device="cpu")
    assert sling.builder == "sling"
    assert torch.equal(sling.hp.keys, inmem.hp.keys)
    assert torch.equal(sling.hp.vals, inmem.hp.vals)


@pytest.mark.parametrize("kwargs, match", [
    ({"d_mode": "degree"}, "uncertified"),
    ({"d_mode": "bogus"}, "d_mode"),
    ({"builder": "bogus"}, "unknown builder"),
])
def test_build_index_scale_refusals_match_reference(tmp_path, kwargs, match):
    r, t = _graphs("dag")
    for fn, g in ((tbuild.build_index_scale, t),
                  (rbuild.build_index_scale, r)):
        path = str(tmp_path / "x.sling")
        extra = {"device": "cpu"} if fn is tbuild.build_index_scale else {}
        with pytest.raises(ValueError, match=match):
            fn(g, path, eps=0.5, **kwargs, **extra)
        assert not os.path.exists(path)
    with pytest.raises(ValueError, match="unknown builder"):
        tbuild.build_index(t, 0.1, exact_d=True, builder="bogus",
                           device="cpu")


def test_uncertified_scale_file_is_refused_unless_allowed(tmp_path):
    r, t = _graphs("er")
    path = str(tmp_path / "u.sling")
    st = tbuild.build_index_scale(t, path, eps=0.5,
                                  uncertified_diagonal=True, device="cpu")
    assert st["d_mode"] == "degree" and st["uncertified_d"]
    for mmap in (False, True):
        assert TIndex.load(path, mmap=mmap, device="cpu").uncertified_d
        with pytest.raises(ValueError, match="uncertified"):
            QueryEngine.from_index_file(path, t, mmap=mmap, device="cpu")
    eng = QueryEngine.from_index_file(
        path, t, EngineConfig(allow_uncertified=True), mmap=True,
        device="cpu")
    assert 0.0 <= eng.pair(0, 1) <= 1.0
    ref = RIndex.load(path)
    got = TIndex.load(path, device="cpu")
    assert ref.uncertified_d
    np.testing.assert_array_equal(got.d.numpy(), np.asarray(ref.d))
    # the default int16 d codes: within their certified bound
    assert np.abs(got.d.numpy() - rbuild.approx_diagonal_degree(r, 0.6)
                  ).max() <= got.quant.d_bound


@pytest.mark.parametrize("builder", ["sling", "prsim"])
def test_build_index_scale_matches_reference_on_the_same_d(tmp_path,
                                                           builder):
    """With the exact diagonal both packages write files of the same
    size, keys, counts and d, with int16 codes at most one step apart
    (the two sparse builds sum in different orders)."""
    r, t = _graphs("powerlaw")
    rpath, tpath = str(tmp_path / "r.sling"), str(tmp_path / "t.sling")
    rs = rbuild.build_index_scale(r, rpath, eps=0.1, builder=builder,
                                  d_mode="exact", block=16)
    ts = tbuild.build_index_scale(t, tpath, eps=0.1, builder=builder,
                                  d_mode="exact", block=16, device="cpu")
    for k in ("n", "width", "entries", "bytes", "quant", "builder",
              "d_mode"):
        assert ts[k] == rs[k], k
    got, ref = TIndex.load(tpath, device="cpu"), RIndex.load(rpath)
    np.testing.assert_array_equal(got.hp.keys.numpy(), ref.hp.keys)
    np.testing.assert_array_equal(got.hp.counts.numpy(), ref.hp.counts)
    # codes of values equal to float64 rounding: at most one step apart
    assert np.abs(got.hp.vals.numpy().astype(np.int32)
                  - ref.hp.vals.astype(np.int32)).max() <= 1
    np.testing.assert_array_equal(got.d.numpy(), np.asarray(ref.d))


SERVED = (("powerlaw", "auto"), ("er", "auto"), ("sinks", "prsim"))


@pytest.mark.parametrize("name, builder", SERVED)
def test_scale_file_served_within_planned_eps(tmp_path, name, builder):
    """A ``build_index_scale`` file (int16, exact d), mapped and served
    by the port's engine: every pair, single-source and top-k answer
    within the planned eps of exact SimRank."""
    r, t = _graphs(name)
    path = str(tmp_path / "s.sling")
    st = tbuild.build_index_scale(t, path, eps=0.1, quant_frac=0.2,
                                  builder=builder, d_mode="exact",
                                  block=16, device="cpu")
    assert st["builder"] == tbuild.resolve_builder(t, builder)[0]
    eng = QueryEngine.from_index_file(path, t, EngineConfig(
        cache_size=0, source_batch=8, pair_batch=64), mmap=True,
        device="cpu")
    assert eng.stats()["quantized"] == "int16"
    S = oracle.exact_simrank(r, 0.6)
    tol = oracle.tolerance(eng.index.plan)
    n = t.n
    uu, vv = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    pairs = eng.pairs(uu.ravel().astype(np.int32),
                      vv.ravel().astype(np.int32)).reshape(n, n)
    assert np.abs(pairs - S).max() <= tol
    src = eng.single_source(np.arange(n, dtype=np.int32))
    assert np.abs(src - S).max() <= tol
    sv, si = eng.topk(np.arange(n, dtype=np.int32), 5)
    assert np.abs(sv - S[np.arange(n)[:, None], si]).max() <= tol


# ----------------------------------------------------------------------
# the port's twin of tests/test_scale.py: 10^5 nodes under an RSS gate
# ----------------------------------------------------------------------
N_SCALE = 100_000
RSS_GATE_MB = 1500       # the reference's gate (tests/test_scale.py)
AS_LIMIT_MB = 16_000     # its address-space ceiling

_CHILD = r"""
import json, os, resource, sys, tempfile
cap = int(sys.argv[1]) * (1 << 20)
resource.setrlimit(resource.RLIMIT_AS, (cap, cap))
n, builder = int(sys.argv[2]), sys.argv[3]

import numpy as np
import torch
from repro_torch.core import build
from repro_torch.core.index import SlingIndex
from repro_torch.graph import generators
from repro_torch.serve import EngineConfig, QueryEngine

g = generators.powerlaw_fast(n, k=6, seed=0)
path = os.path.join(tempfile.mkdtemp(prefix="sling_scale_"), "idx.sling")
stats = build.build_index_scale(g, path, eps=0.5, quant_frac=0.2,
                                quantize="int16", builder=builder,
                                device="cpu")
idx = SlingIndex.load(path, mmap=True)
assert idx.n == n and idx.quant is not None and idx.read_only
assert idx.builder == stats["builder"]
assert builder == "auto" or idx.builder == builder
assert not idx.uncertified_d and stats["d_mode"] == "estimate"

eng = QueryEngine(idx, g, EngineConfig(pair_batch=8, source_batch=2,
                                       k_buckets=(8,)), device="cpu")
us = np.array([0, 1, n // 2, n - 1], np.int32)
src = eng.single_source(us[:2])
sv, si = eng.topk(us[:2], 8)
pair = eng.pair(0, int(us[2]))
ok = (src.shape == (2, n) and bool((src[0] >= 0).all())
      and sv.shape == (2, 8) and 0.0 <= pair <= 1.0
      and bool((np.diff(sv, axis=1) <= 1e-6).all()))

def peak_rss_mb():
    # VmHWM: this process's own high-water mark (resets at exec)
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) / 1024.0
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0

out = {"ok": bool(ok), "n": int(idx.n), "width": int(idx.hp.width),
       "entries": int(stats["entries"]),
       "file_mb": stats["bytes"] / (1 << 20), "maxrss_mb": peak_rss_mb()}
os.remove(path)
print("SCALE_RESULT " + json.dumps(out))
"""


@pytest.mark.scale
@pytest.mark.slow
@pytest.mark.parametrize("builder", ["sling", "prsim"])
def test_torch_scale_build_mmap_serve_under_rss_gate(builder):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         env.get("PYTHONPATH", "")])
    env["MALLOC_ARENA_MAX"] = "4"
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, str(AS_LIMIT_MB), str(N_SCALE),
         builder], capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, (
        f"scale child failed (rc={proc.returncode}); an rlimit kill "
        f"here means the build stopped being out-of-core.\n"
        f"stdout:\n{proc.stdout[-2000:]}\nstderr:\n{proc.stderr[-2000:]}")
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("SCALE_RESULT ")]
    assert line, proc.stdout[-2000:]
    res = json.loads(line[-1][len("SCALE_RESULT "):])
    assert res["ok"], res
    assert res["n"] == N_SCALE
    assert res["entries"] >= N_SCALE  # every node stores >= its l=0 HP
    assert res["maxrss_mb"] < RSS_GATE_MB, (
        f"peak RSS {res['maxrss_mb']:.0f} MB blew the {RSS_GATE_MB} MB "
        f"scale gate: {res}")
