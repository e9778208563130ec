"""Batched single-pair join kernel (Hopper) and its plain version."""
from repro_torch.kernels.hp_join.hp_join import hp_join, hp_join_plain
from repro_torch.kernels.hp_join.ops import fold_sqrt_d, fold_sqrt_d_arrays

__all__ = ["hp_join", "hp_join_plain", "fold_sqrt_d", "fold_sqrt_d_arrays"]
