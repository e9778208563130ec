"""eps-charged index quantization, ported from ``repro/core/quantize.py``.

Shrinks the float payload of a packed SLING index -- the HP row
``vals`` and optionally the diagonal ``d`` -- to int16 codes or
bfloat16, with the per-entry error certified against the plan's
``eps_quant`` reserve (``theory.quant_vals_bound`` /
``theory.quant_d_bound``). Quantization is a storage format: disk, host
memory and mapped pages shrink 2x, while serving dequantizes to float32
at install and upload (``SlingIndex.vals_f32``), so every dispatch
shape and dtype stays the same.

  * ``int16`` -- codes ``round(v / scale)`` with one global
    ``scale = max|v| / 32767``; refused a priori when scale/2 (with the
    float32 slack of the divide and the dequantizing multiply) exceeds
    the planned bound. Code 0 is 0.0 exactly, so PAD slots stay 0.
  * ``bf16`` -- ``torch.bfloat16`` rounding of float32 (to nearest even,
    as the reference's ml_dtypes type); relative error <= 2^-8 per
    entry, certified a priori through 2^-8 max|v| and again against the
    realized error.

Every function takes and returns tensors and computes where they lie.
The codes and scales equal the reference's bit for bit: both packages
divide in float32 (the divisor here is a tensor on the values' device,
since a CUDA divide by a host scalar multiplies by its reciprocal),
round half to even and dequantize with one float32 multiply.

Quantized indexes are read-only: ``update.update_index`` refuses them,
as ``quantize_index`` refuses indexes that carry the Section-5 sidecars
(``reduced``/``marks`` rewrite vals in float32 at query time).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import theory

SCHEMES = ("int16", "bf16")
_INT16_MAX = 32767


@dataclasses.dataclass(frozen=True)
class QuantInfo:
    """Dequantization recipe and the certified per-entry error bounds.

    ``scale`` is the int16 step for vals (1.0 for bf16); ``d_scale`` the
    int16 step of the diagonal's codes, or 0.0 when d stayed float32.
    ``bound``/``d_bound`` are the per-entry caps the codes were
    certified against; they travel with the artifact.
    """
    scheme: str
    scale: float
    bound: float
    d_scale: float = 0.0
    d_bound: float = 0.0

    def to_meta(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_meta(cls, meta: dict) -> "QuantInfo":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(meta) - known
        if unknown:
            raise ValueError(
                f"unknown quantization metadata fields {sorted(unknown)}; "
                "refusing to load an artifact this build cannot dequantize"
            )
        return cls(**meta)


def _require_scheme(scheme: str) -> None:
    if scheme not in SCHEMES:
        raise ValueError(f"unknown quantization scheme {scheme!r}; "
                         f"expected one of {SCHEMES}")


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32).contiguous()


def _divide(v: torch.Tensor, scale: float) -> torch.Tensor:
    """``v / float32(scale)`` as one IEEE float32 divide per entry."""
    return v / torch.tensor(np.float32(scale), device=v.device)


def quantize_array(vals, scheme: str,
                   bound: float) -> tuple[torch.Tensor, float]:
    """Quantize float32 ``vals`` under a certified per-entry bound.

    Returns ``(stored, scale)``: int16 codes or a ``torch.bfloat16``
    tensor on the values' device. Raises ValueError when the scheme
    cannot guarantee ``|dequant(stored) - vals| <= bound`` for every
    entry; the certificate is a priori, so the same data always
    quantizes or always refuses.
    """
    _require_scheme(scheme)
    v = _f32(vals)
    vmax = float(v.abs().max()) if v.numel() else 0.0
    if scheme == "int16":
        # vmax == 0: every code is 0 and the error exactly 0
        scale = vmax / _INT16_MAX if vmax > 0 else 1.0
        # step/2 plus float32 slack: the quotient (<= 32767) carries
        # ~32767 * 2^-24 code units of rounding and the dequantizing
        # product rounds once more; both are covered by the 2^-6 factor
        if vmax > 0 and scale / 2.0 * (1 + 2.0 ** -6) > bound:
            raise ValueError(
                f"int16 step {scale:.3e} cannot meet the per-entry "
                f"bound {bound:.3e} (max |val| = {vmax:.3e}); raise "
                "eps_quant_frac or use bf16")
        return torch.round(_divide(v, scale)).to(torch.int16), float(scale)
    # bf16: unit roundoff 2^-8 for round-to-nearest with 7 stored bits
    if vmax * 2.0 ** -8 > bound:
        raise ValueError(
            f"bf16 relative step cannot meet the per-entry bound "
            f"{bound:.3e} at max |val| = {vmax:.3e}; raise "
            "eps_quant_frac")
    stored = v.to(torch.bfloat16)
    err = float((stored.to(torch.float32) - v).abs().max()) \
        if v.numel() else 0.0
    if err > bound:
        raise ValueError(f"bf16 realized error {err:.3e} exceeds the "
                         f"per-entry bound {bound:.3e}")
    return stored, 1.0


def dequantize_array(stored: torch.Tensor, scheme: str,
                     scale: float) -> torch.Tensor:
    """Inverse of :func:`quantize_array`: float32, where ``stored`` is."""
    _require_scheme(scheme)
    if scheme == "int16":
        # float32(scale) is exact as a Python float: one float32 multiply
        return stored.to(torch.float32) * float(np.float32(scale))
    return stored.to(torch.float32)


def dequantize_vals(stored: torch.Tensor, info: QuantInfo) -> torch.Tensor:
    return dequantize_array(stored, info.scheme, info.scale)


def vals_dtype(info: QuantInfo) -> torch.dtype:
    """Storage dtype of quantized HP vals."""
    _require_scheme(info.scheme)
    return torch.int16 if info.scheme == "int16" else torch.bfloat16


def quantize_index(idx, scheme: str = "int16", quantize_d: bool = True):
    """A new quantized ``SlingIndex`` sharing keys and counts with
    ``idx``; vals (and d when ``quantize_d``) become codes, computed on
    the index's device.

    The plan must reserve ``eps_quant`` (``plan(eps_quant_frac=...)``):
    the per-entry bounds come from it. With ``quantize_d`` the new
    index's d is the dequantized round trip of its codes, so serving
    realizes exactly the charged error and equals what a save and load
    give bit for bit.
    """
    from repro_torch.core.hp_index import HPTable
    from repro_torch.core.index import SlingIndex

    _require_scheme(scheme)
    if idx.quant is not None:
        raise ValueError("index is already quantized")
    if idx.reduced is not None or idx.marks is not None:
        raise ValueError(
            "cannot quantize an index carrying space-reduction "
            "sidecars (reduced/marks rewrite vals in fp32 at query "
            "time); quantize the unreduced index instead")
    p = idx.plan
    b_vals = theory.quant_vals_bound(p, d_channel=quantize_d)
    stored, scale = quantize_array(idx.hp.vals, scheme, b_vals)
    d = _f32(idx.d)
    d_scale = b_d = 0.0
    if quantize_d:
        b_d = theory.quant_d_bound(p)
        d_codes, d_scale = quantize_array(d, "int16", b_d)
        d = dequantize_array(d_codes, "int16", d_scale)
    info = QuantInfo(scheme=scheme, scale=scale, bound=b_vals,
                     d_scale=d_scale, d_bound=b_d)
    hp = HPTable(n=idx.hp.n, width=idx.hp.width, keys=idx.hp.keys,
                 vals=stored, counts=idx.hp.counts, theta=idx.hp.theta,
                 sqrt_c=idx.hp.sqrt_c, l_max=idx.hp.l_max)
    return SlingIndex(plan=p, d=d, hp=hp, builder=idx.builder,
                      uncertified_d=idx.uncertified_d, stale=idx.stale,
                      epoch=idx.epoch, quant=info)


def quantize_d_codes(d: torch.Tensor, info: QuantInfo) -> torch.Tensor:
    """The int16 d codes of a quantized index's (round-tripped) d; exact
    because that d is ``codes * d_scale``."""
    if info.d_scale <= 0:
        raise ValueError("diagonal was not quantized (d_scale == 0)")
    return torch.round(_divide(_f32(d), info.d_scale)).to(torch.int16)
