"""The port's two Hopper kernels' plain versions held against the JAX
reference kernels (Pallas interpret mode) and their references, on the
CPU; and the wrappers' argument contracts.

On the CPU the wrappers (``hp_join``, ``horner_steps``) take the plain
versions because the tensors lie on the CPU. The kernels themselves are
held against the plain versions on the card by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hp_index import INT32_PAD_KEY
from repro.core.single_source import horner_push as rhorner_push
from repro.kernels.horner_push import ops as rhp_ops
from repro.kernels.horner_push import ref as rhp_ref
from repro.kernels.hp_join.hp_join import hp_join as rhp_join
from repro.kernels.hp_join.ref import join_ref
from repro_torch.core import single_source as tss
from repro_torch.kernels.horner_push import (PushLayout, horner_steps,
                                             horner_steps_plain,
                                             resolve_push_backend)
from repro_torch.kernels.hp_join import hp_join, hp_join_plain
from torch_cases import JOIN_CASES, join_rows, port_join, port_push, \
    rand_case

ATOL = 1e-5


# ----------------------------------------------------------------------
# hp_join
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", JOIN_CASES)
def test_hp_join_plain_matches_reference_kernel(case):
    rng = np.random.default_rng(sorted(JOIN_CASES).index(case))
    ku, vu, kv, vv = join_rows(rng, **JOIN_CASES[case])
    ref = np.asarray(rhp_join(*map(jnp.asarray, (ku, vu, kv, vv)),
                              bq=8, interpret=True))
    got = port_join(ku, vu, kv, vv)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    if case == "pad-rows":
        assert np.all(got[[0, 3, 7]] == 0.0)


@pytest.mark.parametrize("K", [64, 128])
def test_hp_join_plain_matches_join_ref_without_duplicates(K):
    rng = np.random.default_rng(K)
    ku, vu, kv, vv = join_rows(rng, 16, K, key_range=2 * K)
    ref = np.asarray(join_ref(*map(jnp.asarray, (ku, vu, kv, vv))))
    np.testing.assert_allclose(port_join(ku, vu, kv, vv), ref, atol=ATOL,
                               rtol=0)


def test_hp_join_wrapper_rejects_bad_arguments():
    keys = torch.zeros((4, 64), dtype=torch.int32)
    vals = torch.zeros((4, 64))
    ids = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        hp_join(keys, vals, ids.long(), ids)
    with pytest.raises(ValueError):
        hp_join(keys, vals[:, :32], ids, ids)
    with pytest.raises(ValueError):
        hp_join(keys.t(), vals.t(), ids, ids)   # not contiguous
    assert hp_join_plain(keys, vals, ids, ids).shape == (2,)


# ----------------------------------------------------------------------
# horner_push
# ----------------------------------------------------------------------
def _check_push(case, *, n, l_max, bn=8, eb=16):
    """Port plain push vs the reference Pallas kernel (interpret), its
    float64 blocked mirror, and the lax push; also the CPU wrapper."""
    got = port_push(case, n, l_max, horner_steps_plain)
    bs, bdl, bw = rhp_ops.block_align_edges(case["src"], case["dst"],
                                            case["w"], n, bn=bn, eb=eb)
    pallas = np.asarray(rhp_ops.horner_push_pallas(
        *map(jnp.asarray, (case["ku"], case["xu"], case["d"], bs, bdl, bw)),
        jnp.float32(case["tau"]), n=n, l_max=l_max, bn=bn, eb=eb, bq=8,
        interpret=True))
    blocked = rhp_ref.horner_push_blocked_ref(
        case["ku"], case["xu"], case["d"], bs, bdl, bw, case["tau"],
        n=n, l_max=l_max, bn=bn)
    lax = np.asarray(rhorner_push(
        *map(jnp.asarray, (case["ku"], case["xu"], case["d"], case["src"],
                           case["dst"], case["w"])),
        jnp.float32(case["tau"]), n=n, l_max=l_max))
    assert got.shape == pallas.shape == blocked.shape == lax.shape
    for ref in (pallas, blocked, lax):
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    # the wrapper on CPU tensors is the plain step
    np.testing.assert_array_equal(port_push(case, n, l_max, horner_steps),
                                  got)
    return got


def test_push_batch_of_one():
    rng = np.random.default_rng(0)
    _check_push(rand_case(rng, n=17, B=1, W=4, l_max=3, m=40), n=17,
                l_max=3)


def test_push_ragged_batch():
    rng = np.random.default_rng(1)
    _check_push(rand_case(rng, n=23, B=9, W=3, l_max=2, m=60), n=23,
                l_max=2)


def test_push_n_not_multiple_of_node_block():
    rng = np.random.default_rng(2)
    got = _check_push(rand_case(rng, n=13, B=4, W=4, l_max=3, m=30), n=13,
                      l_max=3, bn=8, eb=8)
    assert got.shape == (4, 13)


def test_push_empty_frontier_after_prune():
    """tau above every score: only the level-0 seed survives."""
    rng = np.random.default_rng(3)
    case = rand_case(rng, n=11, B=3, W=4, l_max=4, m=40, tau=1e9)
    got = _check_push(case, n=11, l_max=4, eb=8)
    seed0 = np.zeros((3, 11))
    ls = np.where(case["ku"] == INT32_PAD_KEY, -1, case["ku"] // 11)
    ks = np.clip(case["ku"] % 11, 0, 10)
    for b in range(3):
        np.add.at(seed0[b], ks[b],
                  np.where(ls[b] == 0, case["xu"][b] * case["d"][ks[b]], 0))
    np.testing.assert_allclose(got, seed0, atol=ATOL, rtol=0)


def test_push_all_pad_rows():
    rng = np.random.default_rng(4)
    case = rand_case(rng, n=19, B=5, W=4, l_max=3, m=50)
    case["ku"][:] = INT32_PAD_KEY
    assert np.all(_check_push(case, n=19, l_max=3, eb=8) == 0.0)


def test_push_duplicate_keys_accumulate():
    n, k_tgt = 9, 5
    case = dict(src=np.zeros(0, np.int32), dst=np.zeros(0, np.int32),
                w=np.zeros(0, np.float32),
                ku=np.full((1, 2), k_tgt, np.int32),
                xu=np.float32([[0.25, 0.125]]),
                d=np.linspace(0.5, 1.0, n).astype(np.float32),
                tau=np.float32(0.0))
    got = _check_push(case, n=n, l_max=0, bn=4, eb=8)
    assert got[0, k_tgt] == pytest.approx(0.375 * float(case["d"][k_tgt]),
                                          abs=1e-6)


def test_push_tau_zero():
    rng = np.random.default_rng(5)
    _check_push(rand_case(rng, n=21, B=4, W=5, l_max=3, m=70, tau=0.0),
                n=21, l_max=3)


def test_plain_push_is_single_source_horner_push():
    rng = np.random.default_rng(6)
    case = rand_case(rng, n=30, B=8, W=6, l_max=5, m=120)
    lay = PushLayout.from_edges(case["src"], case["dst"], case["w"], 30,
                                "cpu")
    got = tss.horner_push(torch.as_tensor(case["ku"]),
                          torch.as_tensor(case["xu"]),
                          torch.as_tensor(case["d"]), lay,
                          float(case["tau"]), n=30, l_max=5)
    np.testing.assert_array_equal(
        got.numpy(), port_push(case, 30, 5, horner_steps_plain))


def test_push_layout_groups_edges_by_destination():
    rng = np.random.default_rng(7)
    n, m = 25, 90
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    w = rng.random(m).astype(np.float32)
    lay = PushLayout.from_edges(src, dst, w, n, "cpu")
    ptr = lay.in_ptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == m and np.all(np.diff(ptr) >= 0)
    for v in range(n):
        sel = np.flatnonzero(dst == v)   # input order kept within a row
        np.testing.assert_array_equal(lay.in_idx.numpy()[ptr[v]:ptr[v + 1]],
                                      src[sel])
        np.testing.assert_array_equal(lay.w.numpy()[ptr[v]:ptr[v + 1]],
                                      w[sel])


def test_horner_steps_wrapper_rejects_bad_arguments():
    n, B, W = 6, 2, 3
    x = torch.zeros((n, B))
    lay = PushLayout.from_edges([0, 1], [2, 3], [0.5, 0.5], n, "cpu")
    keys = torch.zeros((B, W), dtype=torch.int32)
    contrib = torch.zeros((B, W))
    args = (lay, keys, contrib, 2, 0.0)
    with pytest.raises(ValueError):
        horner_steps(x, torch.zeros((n, B + 1)), *args)
    with pytest.raises(TypeError):
        horner_steps(x.double(), x.double(), *args)
    with pytest.raises(ValueError):
        horner_steps(torch.zeros((B, n)).t(), x, *args)
    with pytest.raises(ValueError):   # a layout of another graph size
        horner_steps(torch.zeros((n + 1, B)), torch.zeros((n + 1, B)),
                     *args)
    spare = torch.empty_like(x)
    # three levels ping-pong x -> spare -> x -> spare
    assert horner_steps(x, spare, *args) is spare


def test_push_layout_splits_nodes_by_in_degree():
    from repro_torch.kernels.horner_push.ops import HEAVY_DEGREE
    n = 50
    dst = np.concatenate([np.full(HEAVY_DEGREE + 1, 3), np.full(40, 7),
                          np.arange(n)])
    src = np.arange(len(dst)) % n
    lay = PushLayout.from_edges(src, dst, np.ones(len(dst)), n, "cpu")
    assert lay.heavy.tolist() == [3, 7]
    assert sorted(lay.light.tolist() + lay.heavy.tolist()) == list(range(n))
    assert lay.heavy.dtype == lay.light.dtype == torch.int32


def test_push_backend_resolves_by_device():
    assert resolve_push_backend("auto", "cpu") == "plain"
    assert resolve_push_backend("auto", "cuda") == "kernel"
    assert resolve_push_backend("kernel", "cpu") == "kernel"
    with pytest.raises(ValueError):
        resolve_push_backend("pallas", "cpu")
