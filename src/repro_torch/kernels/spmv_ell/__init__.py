"""The Â operator (``spmm``) as a Hopper kernel, its plain version, the
live-segment mask of a pruned frontier (``segment_live``) and its CSR
layout (pull over the in-CSR, transposed push over the out-CSR)."""
from repro_torch.kernels.spmv_ell.ops import (HEAVY_DEGREE, PUSH_TIERS,
                                             SpmmLayout)
from repro_torch.kernels.spmv_ell.spmv_ell import (mask_words, segment_live,
                                                   spmm, spmm_plain)

__all__ = ["HEAVY_DEGREE", "PUSH_TIERS", "SpmmLayout", "mask_words",
           "segment_live", "spmm", "spmm_plain"]
