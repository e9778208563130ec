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
The port trains on one device, so the file always holds whole leaves
(the reference's shardings and mesh have no counterpart here).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.optim.adamw import AdamWState, named_leaves


def _to_np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def _opt_leaves(opt_state: AdamWState) -> list[tuple[str, torch.Tensor]]:
    return ([(".step", opt_state.step)]
            + [(f".m/{n}", t) for n, t in opt_state.m.items()]
            + [(f".v/{n}", t) for n, t in opt_state.v.items()])


def save(ckpt_dir: str, step: int, params: Any,
         opt_state: Optional[AdamWState] = None,
         extra: Optional[dict] = None) -> str:
    leaves_p = named_leaves(params)
    payload = {f"p/{n}": _to_np(v) for n, v in leaves_p}
    names_o = []
    if opt_state is not None:
        leaves_o = _opt_leaves(opt_state)
        names_o = [n for n, _ in leaves_o]
        payload.update({f"o/{n}": _to_np(v) for n, v in leaves_o})
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "shard_0.npz"), **payload)
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
            opt_like: Optional[AdamWState] = None):
    """(params, opt_state, manifest) from a checkpoint. The stored
    arrays are copied into ``params_like``'s tensors and ``opt_like``'s
    (each re-cast to its tensor's dtype, on its device), which are
    returned: the port fills the given trees in place where the
    reference builds new ones."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "shard_0.npz")) as z:
        def fill(leaves, prefix):
            for name, t in leaves:
                arr = torch.from_numpy(np.asarray(z[f"{prefix}/{name}"]))
                if tuple(arr.shape) != tuple(t.shape):
                    raise ValueError(f"{prefix}/{name}: stored shape "
                                     f"{tuple(arr.shape)}, expected "
                                     f"{tuple(t.shape)}")
                t.copy_(arr.to(t.dtype))

        fill(named_leaves(params_like), "p")
        if opt_like is not None:
            fill(_opt_leaves(opt_like), "o")
    return params_like, opt_like, manifest
