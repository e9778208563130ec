"""Train a GCN node classifier with SLING SimRank anchor features
materialized by the bulk join, on the PyTorch port (paper technique as
a first-class feature input, DESIGN.md sections 5 and 10).

The anchor features are a *static* similarity artifact: instead of
issuing single-source queries per anchor (the online engine's job),
one device-streamed sweep (repro_torch.join) materializes a KnnGraph
over the anchors, which is saved/loaded like any artifact and scattered
into the (n, n_anchors) feature block consumed by the model.

    PYTHONPATH=src python examples/torch_train_gnn_simrank.py \
        [--steps 300] [--device D]

Everything runs on ``--device`` (``cuda`` by default: the index build
through the ``spmm`` kernel, the join through the Horner push kernel,
then the GCN's training steps).
"""
import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs import base as cfg_base
from repro_torch.core import build
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.graph import generators
from repro_torch.join import JoinConfig, KnnGraph, run_join
from repro_torch.models import gnn as G
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.train.trainer import TrainerConfig, fit


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=600)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--anchors", type=int, default=8)
    ap.add_argument("--knn-k", type=int, default=64,
                    help="neighbors kept per anchor (sparsified feature)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    g = generators.barabasi_albert(args.n, 4, seed=0, directed=False)
    print(f"graph n={g.n} m={g.m}")

    # SLING anchor features, materialized once by the bulk join: the
    # top knn_k similarity scores from each hub anchor, as a versioned
    # KnnGraph artifact (scores below the k-th stay 0 in the feature)
    idx = build.build_index(g, eps=0.2, seed=0, device=dev)
    anchors = np.argsort(-g.in_deg)[:args.anchors].astype(np.int32)
    knn = run_join(idx, g, sources=anchors,
                   config=JoinConfig(k=args.knn_k, tile=args.anchors),
                   device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "anchor_knn.npz")
        knn.save(path)
        knn = KnnGraph.load(path)   # consumers read the artifact
    sim = np.zeros((g.n, len(anchors)), np.float32)
    for j, a in enumerate(anchors):
        ids, scores = knn.neighbors(int(a))
        sim[ids, j] = scores
    print(f"SimRank anchor features via bulk join: {sim.shape}, "
          f"{knn.nnz} stored scores (eps cert {knn.eps}), "
          f"mean {sim.mean():.4f}")

    cfg = dataclasses.replace(cfg_base.get("gcn-cora").smoke(),
                              d_in=16, sim_feats=len(anchors), d_hidden=16)
    batch = pipeline.gnn_batch(g, cfg.d_in, cfg.n_classes, sim_feat=sim)
    params = G.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    opt = AdamW(lr=cosine_schedule(1e-2, warmup=20, total=args.steps),
                weight_decay=0.01)
    params, _, hist = fit(lambda p, b: G.loss_fn(cfg, p, b), params,
                          lambda s: batch, opt,
                          TrainerConfig(steps=args.steps, log_every=50))

    with torch.inference_mode():
        out = G.forward(cfg, params, batch)
    acc = float((out.argmax(-1).cpu().numpy() == batch["labels"]).mean())
    print(f"final train accuracy: {acc:.3f} (loss {hist[0][1]:.3f} -> "
          f"{hist[-1][1]:.3f})")


if __name__ == "__main__":
    main()
