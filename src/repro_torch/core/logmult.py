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


def ilm_pair(a, b, cfg: P.PositConfig, n: int, m: int | None,
             sublane: int | None = None):
    """Elementwise ILM product of two float tensors through posit ``cfg``
    (the paper's Table I operating points)."""
    va, ra = ilm_planes_from_float(a, cfg, n, m, sublane)
    vb, rb = ilm_planes_from_float(b, cfg, n, m, sublane)
    return va * vb - ra * rb


# --------------------------------------------------------------------------
# Log-fixed-point baseline (paper Table VI "Log-fxp_n" rows)
# --------------------------------------------------------------------------

def fxp_frac_exp(x, bits: int, group=None) -> torch.Tensor:
    """The per-tensor fraction exponent of :func:`fxp_quantize`: the
    largest magnitude lands just below ``2^(bits - 2)`` (int32, 0-dim).
    ``group``: the process group over which ``x``'s rows are split; the
    max is then taken over it."""
    amax = torch.max(torch.abs(x))
    if group is not None:
        import torch.distributed as dist
        from repro_torch.distributed.collectives import all_reduce
        amax = all_reduce(amax.clone(), group, dist.ReduceOp.MAX)
    amax = amax + 1e-30
    return (bits - 2) - torch.ceil(torch.log2(amax)).to(torch.int32)


def fxp_quantize(x, bits: int, frac_bits=None):
    """Symmetric fixed-point quantization with a per-tensor power-of-2
    scale ``2^frac_exp``.  Returns (dequantized, integer codes, scale).

    The scale is the exact power of two (``torch.exp2``); the reference's
    ``jnp.exp2`` on XLA:CPU is not exact for |frac_exp| >= 13 (ROADMAP
    queue 3), so the two agree bit for bit only below that."""
    x = torch.as_tensor(x)
    frac_exp = (fxp_frac_exp(x, bits) if frac_bits is None
                else torch.as_tensor(frac_bits, dtype=torch.int32,
                                     device=x.device))
    scale = torch.exp2(frac_exp.to(torch.float32))
    lim = 2 ** (bits - 1) - 1
    q = torch.clamp(torch.round(x * scale), -lim, lim)
    return q / scale, q.to(torch.int32), scale


def logfxp_planes(x, bits: int, n: int, frac_bits=None):
    """ILM planes for the log-fixed-point baseline multiplier: the codes'
    magnitudes with their top ``n`` set bits cleared.  ``frac_bits`` fixes
    the exponent (a slice of a tensor whose exponent came from the
    whole)."""
    _, q, scale = fxp_quantize(x, bits, frac_bits)
    mag = torch.abs(q).to(torch.int64)
    rem_mag = clear_top_set_bits(mag, n)
    sgn = torch.sign(q).to(torch.float32)
    val = sgn * mag.to(torch.float32) / scale
    rem = sgn * rem_mag.to(torch.float32) / scale
    return val, rem


# --------------------------------------------------------------------------
# Bit-exact integer oracle of the literal per-stage ILM (for tests)
# --------------------------------------------------------------------------

def np_ilm_exact(A: int, B: int, n: int) -> int:
    """Literal n-stage iterative logarithmic multiplier on integers."""
    A, B, out = int(A), int(B), 0
    for _ in range(n):
        if A == 0 or B == 0:
            break
        ka, kb = A.bit_length() - 1, B.bit_length() - 1
        ra, rb = A - (1 << ka), B - (1 << kb)
        out += (1 << (ka + kb)) + (ra << kb) + (rb << ka)
        A, B = ra, rb
    return out


def np_clear_top_set_bits(x: int, k: int) -> int:
    x = int(x)
    for _ in range(k):
        if x == 0:
            break
        x &= ~(1 << (x.bit_length() - 1))
    return x
