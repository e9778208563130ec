"""The port's Hopper kernels on the card, each held against its plain
PyTorch version; and the rule that a CUDA tensor runs the kernel or
raises. Every test here needs an NVIDIA card and nvcc and skips
without one:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.horner_push import (PushLayout, horner_push,
                                             horner_steps, horner_steps_plain)
from repro_torch.kernels.hp_join import hp_join
from torch_cases import JOIN_CASES, join_rows, port_join, port_push, \
    rand_case

ATOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no "
                    "interpret mode; run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_cuda.py`")
    return torch.device("cuda")


@pytest.mark.cuda
def test_wrappers_raise_without_library_on_card(card, monkeypatch, tmp_path):
    """A CUDA tensor either runs the kernel or raises: with no nvcc and
    no built library the wrappers raise instead of falling back."""
    # the packages re-export functions under their modules' names
    hp_mod = importlib.import_module(
        "repro_torch.kernels.horner_push.horner_push")
    hj_mod = importlib.import_module("repro_torch.kernels.hp_join.hp_join")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(hj_mod, "_launch", [])
    monkeypatch.setattr(hp_mod, "_launch", [])
    keys = torch.zeros((2, 64), dtype=torch.int32, device=card)
    ids = torch.zeros(2, dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError, match="nvcc"):
        hp_join(keys, keys.float(), ids, ids)
    lay = PushLayout.from_edges([0], [1], [0.5], 2, card)
    x = torch.zeros((2, 2), device=card)
    with pytest.raises(RuntimeError, match="nvcc"):
        horner_steps(x, torch.empty_like(x), lay, keys, keys.float(), 0, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", JOIN_CASES)
def test_hp_join_kernel_matches_plain_on_card(card, case):
    rng = np.random.default_rng(sorted(JOIN_CASES).index(case))
    ku, vu, kv, vv = join_rows(rng, **JOIN_CASES[case])
    B = ku.shape[0]
    keys = torch.as_tensor(np.concatenate([ku, kv]), device=card)
    vals = torch.as_tensor(np.concatenate([vu, vv]), device=card)
    us = torch.arange(B, dtype=torch.int32, device=card)
    before = hp_join.launches
    got = hp_join(keys, vals, us, us + B)
    assert hp_join.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               port_join(ku, vu, kv, vv), atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(6))
def test_horner_kernel_matches_plain_on_card(card, seed):
    """Random graphs with hubs above the heavy split, batch widths that
    do and do not divide the block (1, 3, 8, 9, 32, 300)."""
    rng = np.random.default_rng(seed)
    n, l_max = 40 + 7 * seed, 4
    B = [1, 3, 8, 9, 32, 300][seed]
    case = rand_case(rng, n=n, B=B, W=6, l_max=l_max, m=4 * n,
                      tau=[0.0, 1e-4, 5e-2, 1e9, 1e-4, 0.0][seed])
    hub = np.full(3 * 40, seed % n)              # one node of in-degree 120
    case["src"] = np.concatenate([case["src"],
                                  rng.integers(0, n, len(hub))])
    case["dst"] = np.concatenate([case["dst"], hub]).astype(np.int32)
    case["w"] = np.concatenate([case["w"], rng.uniform(0.05, 0.6,
                                                       len(hub))])
    lay = PushLayout.from_edges(case["src"], case["dst"], case["w"], n, card)
    assert lay.heavy.numel() >= 1
    args = [torch.as_tensor(case[k], device=card) for k in ("ku", "xu", "d")]
    before = horner_steps.launches
    got = horner_push(*args, lay, float(case["tau"]), n=n, l_max=l_max)
    assert horner_steps.launches == before + l_max + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               port_push(case, n, l_max, horner_steps_plain),
                               atol=ATOL, rtol=0)
