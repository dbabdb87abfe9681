"""Stage-adaptive iterative logarithmic multiplication (ILM) with truncation.

Counterpart of ``repro.core.logmult``.  The n-stage ILM telescopes exactly:

    ILM_n(A, B) = A*B - rem_n(A) * rem_n(B)

where ``rem_n(X)`` is X with its top ``n`` set bits cleared, so an ILM
matmul is two exact matmuls on per-operand (val, rem) planes.
"""
from __future__ import annotations

import torch

from . import posit as P


def leading_one_pos(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for integer x >= 1 below 2^53 (float64 frexp is
    exact there; torch has no count-leading-zeros)."""
    return torch.frexp(x.to(torch.float64))[1].to(torch.int64) - 1


def clear_top_set_bits(x, k: int):
    """Clear the top ``k`` set bits of integer ``x`` (static k)."""
    x = torch.as_tensor(x).to(torch.int64)
    for _ in range(k):
        nz = x != 0
        pos = leading_one_pos(torch.where(nz, x, torch.ones_like(x)))
        x = torch.where(nz, x & ~(1 << pos), x)
    return x


def truncate_mantissa(frac, W: int, m: int | None):
    """Keep only the top ``m`` fraction bits below the leading (implicit) one."""
    frac = torch.as_tensor(frac).to(torch.int64)
    if m is None or m >= W:
        return frac
    drop = W - m
    return (frac >> drop) << drop


def effective_trunc(m: int | None, sublane: int | None) -> int | None:
    """Truncation width after the SIMD sub-lane cap."""
    if sublane is not None:
        return min(m, sublane - 1) if m is not None else sublane - 1
    return m


def ilm_planes_from_fields(sign, scale, frac, is_zero, W: int, n: int,
                           m: int | None, sublane: int | None = None,
                           dtype=torch.float32):
    """Build the (val, rem) float planes realizing the ILM identity.

    ILM product of a pair (a, b) = va*vb - ra*rb; see the reference's
    docstring for the knobs (W window, n stages, m truncation, sublane)."""
    frac_t = truncate_mantissa(frac, W, effective_trunc(m, sublane))
    mant = (1 << W) | frac_t
    # stage 1 strips the implicit leading one; stages 2..n strip frac bits
    rem_mant = clear_top_set_bits(mant, n)
    one = torch.ones((), dtype=dtype, device=mant.device)
    sgn = torch.where(sign == 1, -one, one)
    unit = sgn * P.pow2(scale - W).to(dtype)  # (-1)^s * 2^(scale - W)
    val = unit * mant.to(dtype)
    rem = unit * rem_mant.to(dtype)
    zero = torch.zeros((), dtype=dtype, device=mant.device)
    return torch.where(is_zero, zero, val), torch.where(is_zero, zero, rem)


def ilm_planes_from_float(x, cfg: P.PositConfig, n: int, m: int | None,
                          sublane: int | None = None, dtype=torch.float32):
    """Quantize a float tensor to posit ``cfg`` and build ILM planes."""
    pat = P.encode_from_float(x, cfg)
    f = P.decode_fields(pat, cfg)
    return ilm_planes_from_fields(f["sign"], f["scale"], f["frac"],
                                  f["is_zero"] | f["is_nar"],
                                  cfg.frac_window, n, m, sublane, dtype)
