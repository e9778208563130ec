"""Input makers shared by the port's kernel and model tests (no JAX
here: the card-only tests in tests/test_torch_cuda.py run where JAX is
absent)."""
import numpy as np
import torch

from repro_torch.core.hp_index import INT32_PAD_KEY
from repro_torch.kernels.horner_push import horner_push
from repro_torch.kernels.hp_join import hp_join
from repro_torch.kernels.spmv_ell import SpmmLayout

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


def port_push(case, n, l_max):
    """The port's plain Horner push on a case's rows, on the CPU."""
    lay = SpmmLayout.from_edges(case["src"], case["dst"], case["w"], n,
                                "cpu")
    return horner_push(torch.as_tensor(case["ku"]),
                       torch.as_tensor(case["xu"]),
                       torch.as_tensor(case["d"]), lay, float(case["tau"]),
                       n=n, l_max=l_max).numpy()


def table_case(rng, *, n, rows, W, l_max, m, hubs=(), tau=1e-4,
               pad_frac=0.3, dup=False):
    """A packed table as the index stores it -- (rows, W) keys sorted
    ascending per row with PAD last, float32 values -- over a random
    graph whose ``hubs`` each get 3 * 40 extra in-edges (in-degree above
    the heavy split), weighted as Â is: sqrt(c) / |I(v)| with c = 0.6,
    so that scores stay at SimRank's scale."""
    case = rand_case(rng, n=n, B=rows, W=W, l_max=l_max, m=m, tau=tau,
                     pad_frac=pad_frac)
    if dup:   # duplicate keys inside each row
        case["ku"][:, 1::2] = case["ku"][:, 0::2][:, :W // 2]
    case["ku"] = np.sort(case["ku"], axis=1)
    extra = np.repeat(np.asarray(hubs, np.int64), 3 * 40)
    case["src"] = np.concatenate([case["src"], rng.integers(0, n, len(extra))
                                  ]).astype(np.int32)
    case["dst"] = np.concatenate([case["dst"], extra]).astype(np.int32)
    indeg = np.bincount(case["dst"], minlength=n)
    case["w"] = (np.sqrt(0.6) / indeg[case["dst"]]).astype(np.float32)
    return case


def condition_lm(cfg, model) -> None:
    """Scale an LM's wq by sqrt(H / d_model) and wk, wv by sqrt(K /
    d_model) in place: fan_in d_model where the reference's
    ``dense_init`` takes the head count, so that the random-init model
    is well-conditioned (tests/test_torch_lm.py's ``_conditioned``)."""
    with torch.no_grad():
        for name, heads in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads),
                            ("wv", cfg.n_kv_heads)):
            getattr(model.blocks, name).mul_(
                float(np.float32(np.sqrt(heads / cfg.d_model))))
