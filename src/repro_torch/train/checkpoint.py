"""Checkpoints in the reference's layout (port of
``repro/train/checkpoint.py``), so that a checkpoint written by either
package restores in the other.

Layout: <dir>/step_<N>/
  manifest.json  -- step, n_hosts (1), keys_p, keys_o, extra
  shard_0.npz    -- every leaf whole: "p/<name>" for the parameters,
                    "o/.step", "o/.m/<name>", "o/.v/<name>" for the
                    AdamW state, the names of ``adamw.named_leaves``

Writes go to step_<N>.tmp, then ``os.replace``. npz has no bf16: such a
leaf is stored as float32 and re-cast to the leaf's dtype on restore.
The file holds whole leaves whatever mesh wrote it, so a restore may
place them on another mesh (``train/elastic.py``'s ``remesh``): with
``shardings`` each leaf comes back as a ``launch.sharding.ShardedTensor``
under its placement on the current mesh.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.optim.adamw import AdamWState, named_leaves, state_leaves


def _to_np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def save(ckpt_dir: str, step: int, params: Any,
         opt_state: Optional[AdamWState] = None,
         extra: Optional[dict] = None) -> str:
    leaves_p = named_leaves(params)
    payload = {f"p/{n}": _to_np(v) for n, v in leaves_p}
    names_o = []
    if opt_state is not None:
        leaves_o = state_leaves(opt_state)
        names_o = [n for n, _ in leaves_o]
        payload.update({f"o/{n}": _to_np(v) for n, v in leaves_o})
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "shard_0.npz"), **payload)  # slinglint: disable=banned-api -- writes inside the tmp dir os.replace'd below
    manifest = {
        "step": step,
        "n_hosts": 1,
        "keys_p": [n for n, _ in leaves_p],
        "keys_o": names_o,
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_", 1)[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


@torch.no_grad()
def restore(ckpt_dir: str, step: int, params_like: Any,
            opt_like: Optional[AdamWState] = None, mesh=None,
            shardings: Optional[dict] = None,
            opt_shardings: Optional[AdamWState] = None):
    """(params, opt_state, manifest) from a checkpoint.

    Without ``shardings`` the stored arrays are copied into
    ``params_like``'s tensors and ``opt_like``'s (each re-cast to its
    tensor's dtype, on its device), which are returned: the port fills
    the given trees in place where the reference builds new ones.

    With ``shardings`` ({path: NamedSharding}, ``launch.sharding.
    tree_shardings`` of the parameters) the parameters come back as
    {path: ShardedTensor}, each leaf re-cast to ``params_like``'s dtype
    and placed under its sharding: this is where elastic resharding
    happens (the stored arrays are mesh-agnostic; placement follows the
    current mesh). ``opt_shardings`` (an ``AdamWState`` of shardings)
    does the same for the optimizer state, which then comes back as an
    ``AdamWState`` of ShardedTensors. ``mesh`` is the reference's and
    is not read: each sharding names its mesh."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "shard_0.npz")) as z:
        def stored(key, t):
            arr = torch.from_numpy(np.asarray(z[key]))
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{key}: stored shape {tuple(arr.shape)}, "
                                 f"expected {tuple(t.shape)}")
            return arr.to(t.dtype)

        def fill(leaves, prefix):
            for name, t in leaves:
                t.copy_(stored(f"{prefix}/{name}", t))

        def placed(leaves, prefix, shards):
            shards = dict(shards)
            if set(shards) != {n for n, _ in leaves}:
                raise ValueError(f"shardings for {sorted(shards)}, leaves "
                                 f"{[n for n, _ in leaves]}")
            return {n: shards[n].shard(stored(f"{prefix}/{n}", t))
                    for n, t in leaves}

        if shardings is None:
            fill(named_leaves(params_like), "p")
            params = params_like
        else:
            params = placed(named_leaves(params_like), "p",
                            named_leaves(shardings))
        opt_state = opt_like
        if opt_like is not None and opt_shardings is None:
            fill(state_leaves(opt_like), "o")
        elif opt_like is not None:
            o = placed(state_leaves(opt_like), "o",
                       state_leaves(opt_shardings))
            opt_state = AdamWState(
                step=o[".step"],
                m={n[3:]: t for n, t in o.items() if n.startswith(".m/")},
                v={n[3:]: t for n, t in o.items() if n.startswith(".v/")})
    return params, opt_state, manifest
