"""The Â operator (``spmm``) as a Hopper kernel, its plain version and
its CSR layout (pull over the in-CSR, transposed push over the
out-CSR)."""
from repro_torch.kernels.spmv_ell.ops import HEAVY_DEGREE, SpmmLayout
from repro_torch.kernels.spmv_ell.spmv_ell import spmm, spmm_plain

__all__ = ["HEAVY_DEGREE", "SpmmLayout", "spmm", "spmm_plain"]
