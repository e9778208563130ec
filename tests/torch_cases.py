"""Input makers shared by the port's kernel tests (no JAX here: the
card-only tests in tests/test_torch_cuda.py run where JAX is absent)."""
import numpy as np
import torch

from repro_torch.core.hp_index import INT32_PAD_KEY
from repro_torch.kernels.horner_push import PushLayout, horner_push
from repro_torch.kernels.hp_join import hp_join

JOIN_CASES = {
    "ragged-K64": dict(B=16, K=64, key_range=150),
    "ragged-K128": dict(B=8, K=128, key_range=300),
    "pad-rows": dict(B=8, K=64, key_range=120, pad_rows=(0, 3, 7)),
    "duplicate-keys": dict(B=8, K=64, key_range=40, dup=True),
    "duplicate-keys-K128": dict(B=16, K=128, key_range=90, dup=True),
}


def join_rows(rng, B, K, *, key_range, dup=False, pad_rows=()):
    """(B, K) sorted key rows with ragged PAD tails, float32 values."""
    ku = np.full((B, K), INT32_PAD_KEY, np.int32)
    kv = np.full((B, K), INT32_PAD_KEY, np.int32)
    for rows in (ku, kv):
        for b in range(B):
            c = int(rng.integers(0, K + 1))
            if b in pad_rows:
                c = 0
            if dup:
                r = np.sort(rng.integers(0, key_range, c))
            else:
                r = np.sort(rng.choice(key_range, size=c, replace=False))
            rows[b, :c] = r
    vu = rng.uniform(0.01, 1.0, (B, K)).astype(np.float32)
    vv = rng.uniform(0.01, 1.0, (B, K)).astype(np.float32)
    vu[ku == INT32_PAD_KEY] = 0.0
    vv[kv == INT32_PAD_KEY] = 0.0
    return ku, vu, kv, vv


def port_join(ku, vu, kv, vv):
    """The port's hp_join on rows (B, K) of u and v (CPU tensors)."""
    B = ku.shape[0]
    keys = torch.as_tensor(np.concatenate([ku, kv]))
    vals = torch.as_tensor(np.concatenate([vu, vv]))
    us = torch.arange(B, dtype=torch.int32)
    return hp_join(keys, vals, us, us + B).numpy()


def rand_case(rng, *, n, B, W, l_max, m, tau=1e-4, pad_frac=0.3):
    """The reference kernel suite's case maker (unsorted rows, PAD
    anywhere, arbitrary per-edge weights)."""
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    w = rng.uniform(0.05, 0.6, m).astype(np.float32)
    ku = (rng.integers(0, l_max + 1, (B, W)) * n
          + rng.integers(0, n, (B, W))).astype(np.int32)
    ku[rng.random((B, W)) < pad_frac] = INT32_PAD_KEY
    xu = rng.uniform(0.01, 1.0, (B, W)).astype(np.float32)
    d = rng.uniform(0.3, 1.0, n).astype(np.float32)
    return dict(src=src, dst=dst, w=w, ku=ku, xu=xu, d=d,
                tau=np.float32(tau))


def port_push(case, n, l_max, steps):
    """The port's Horner loop on a case, on the CPU, with ``steps``."""
    lay = PushLayout.from_edges(case["src"], case["dst"], case["w"], n,
                                "cpu")
    return horner_push(torch.as_tensor(case["ku"]),
                       torch.as_tensor(case["xu"]),
                       torch.as_tensor(case["d"]), lay, float(case["tau"]),
                       n=n, l_max=l_max, steps=steps).numpy()
