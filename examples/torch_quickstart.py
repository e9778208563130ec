"""Quickstart on the PyTorch port: build a SLING index, answer every
query type, and verify the Theorem-1 error bound against the power
method.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The index is built and the pairs are served on ``--device`` (``cuda``
by default: the hand-written kernels on an NVIDIA card).
"""
import argparse

import numpy as np

from repro_torch.baselines import power
from repro_torch.core import build
from repro_torch.core.single_source import single_source_horner
from repro_torch.graph import generators


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 1. a graph (synthetic stand-in for the paper's SNAP datasets)
    g = generators.barabasi_albert(args.n, 3, seed=0, directed=False)
    print(f"graph: n={g.n}, m={g.m}")

    # 2. build the index (eps = max additive error per score)
    idx = build.build_index(g, eps=0.1, seed=0, device=args.device,
                            verbose=True)
    print(f"index: {idx.nbytes() / 1e6:.2f} MB, "
          f"{int(idx.hp.counts.sum())} HP entries, "
          f"plan: eps_d={idx.plan.eps_d:.4f} theta={idx.plan.theta:.5f}")

    # 3. single-pair queries (batched device path)
    rng = np.random.default_rng(0)
    us, vs = rng.integers(0, g.n, 5), rng.integers(0, g.n, 5)
    scores = idx.query_pairs(us, vs, device=args.device)
    for u, v, s in zip(us, vs, scores):
        print(f"  s({u}, {v}) ~= {s:.4f}")

    # 4. single-source query (Horner-stacked push, beyond-paper)
    ss = single_source_horner(idx, g, int(us[0]))
    top = np.argsort(-ss)[:5]
    print(f"  top-5 most similar to node {us[0]}: {list(top)}")

    # 5. verify against ground truth
    S = power.all_pairs(g, c=0.6, iters=50)
    err = abs(scores - S[us, vs]).max()
    print(f"max error vs power method: {err:.5f} (bound eps=0.1) -> "
          f"{'OK' if err <= 0.1 else 'VIOLATION'}")


if __name__ == "__main__":
    main()
