"""Shared compile-cache introspection (the dynamic recompile gates).

Port of ``repro/analysis/runtime.py``. The zero-recompile invariants are
enforced twice: statically by the jit-boundary pass
(``analysis/jaxpr_passes.py``) and dynamically by counters that benches
and tests assert around. The port compiles no program per shape (eager
PyTorch, and kernels built once per process), so of the reference's
three counters only the join's has a counterpart: the distinct tile
shapes the sweeps dispatched (``join/sweep.py``).

Not ported, by design: ``compile_count(*jitted)`` sums jax's per-function
pjit caches, which eager PyTorch does not have, and
``walk_compile_count`` counted the paired-walk programs, whose port
(``core/walks.py``) runs each chunk at its own size and keeps no count.
"""
from __future__ import annotations


def join_compile_count() -> int:
    """Distinct (tile, kq, backend) tile-program shapes the join sweeps
    of this process dispatched (the recompiles-across-tiles gate)."""
    from repro_torch.join import sweep
    return sweep.compile_count()
