"""A frozen copy of the bounded-posit codec and the ILM planes that the
reference needs, in plain torch.

The paper's arithmetic as the configurations state it: an operand is
divided by its power-of-2 pre-scale ``s`` (2 to the rounded mean log2 of
its normal nonzero magnitudes), rounded to the nearest posit of the format
(round to nearest even in the pattern domain, clamped to minpos/maxpos, a
subnormal or zero input is 0), and split into ILM planes: ``val`` the
posit value with its fraction truncated to ``m`` bits, ``rem`` the same
mantissa with its top ``n`` set bits cleared.  The ILM product of a pair
is ``val_a * val_b - rem_a * rem_b``, so an ILM contraction is two exact
contractions.  Patterns are int64 masked to the word width.

This file is the yardstick's own copy: it imports nothing of the program,
so a change to the program's codec cannot move it.
"""
from __future__ import annotations

import dataclasses

import torch

_GUARD = 26
MIN_NORMAL = 2.0 ** -126

# (n_low, n_high, m_low, m_high) per width, and the regime bound
_KNOBS = {8: (2, 3, 4, 5), 16: (4, 6, 8, 10), 32: (8, 12, 16, 20)}
_RBOUND = {8: 2, 16: 3, 32: 5}
_ES = {8: 0, 16: 1, 32: 2}


@dataclasses.dataclass(frozen=True)
class Format:
    """A bounded posit format and the ILM knobs of one paper variant."""

    n_bits: int
    es: int
    regime_max: int
    stages: int
    trunc: int | None

    @property
    def rcap(self) -> int:
        return self.regime_max

    @property
    def k_max(self) -> int:
        return self.regime_max - 1

    @property
    def k_min(self) -> int:
        return -self.regime_max

    @property
    def frac_window(self) -> int:
        return self.n_bits - 1 - self.es

    @property
    def max_scale(self) -> int:
        return self.k_max * (1 << self.es) + (1 << self.es) - 1

    @property
    def min_scale(self) -> int:
        return self.k_min * (1 << self.es)


def variant(width: int, name: str) -> Format:
    """The format of a bounded paper variant such as ``L-21b``."""
    if not name.endswith("b"):
        raise ValueError(f"only bounded variants are served: {name}")
    n_lo, n_hi, m_lo, m_hi = _KNOBS[width]
    n, m = {"L-1": (n_lo, None), "L-2": (n_hi, None), "L-21": (n_hi, m_lo),
            "L-22": (n_hi, m_hi)}[name[:-1]]
    return Format(width, _ES[width], _RBOUND[width], n, m)


def _mask(nbits: int) -> int:
    return (1 << nbits) - 1


def _exp2i(e):
    bits = (e.to(torch.int32).clamp(-126, 127) + 127) << 23
    return bits.view(torch.float32)


def pow2(e):
    """Exact 2^e as two exponent-field factors."""
    e = e.to(torch.int32)
    h1 = torch.div(e, 2, rounding_mode="floor")
    return _exp2i(h1) * _exp2i(e - h1)


def flush(t):
    """Subnormal values become (signed) zero."""
    return torch.where(t.abs() < MIN_NORMAL, t * 0.0, t)


def _rne_shift(v, sh):
    sh_u = torch.clamp(sh, 1, 31)
    half = (1 << (sh_u - 1)) - 1
    lsb = (v >> sh_u) & 1
    out = (v + half + lsb) >> sh_u
    return torch.where(sh <= 0, v, out)


def encode(x, f: Format):
    """Float32 tensor -> posit patterns (int64, low n_bits valid)."""
    N, es, G = f.n_bits, f.es, _GUARD
    xf = x.to(torch.float32)
    sign = torch.signbit(xf)
    a = xf.abs()
    is_zero = a < MIN_NORMAL
    is_nar = ~torch.isfinite(xf)
    m, ex = torch.frexp(torch.where(is_zero | is_nar, torch.ones_like(a), a))
    scale = ex.to(torch.int64) - 1
    mant = m * 2.0
    over = scale > f.max_scale
    under = scale < f.min_scale
    scale_c = torch.clamp(scale, f.min_scale, f.max_scale)
    mant = torch.where(over | under, torch.ones_like(mant), mant)
    k = scale_c >> es
    e = scale_c - k * (1 << es)
    pos = k >= 0
    at_hi = k == f.k_max
    at_lo = k == f.k_min
    w_pos = torch.where(at_hi, torch.full_like(k, f.rcap), k + 2)
    w_neg = torch.where(at_lo, torch.full_like(k, f.rcap), -k + 1)
    w = torch.where(pos, w_pos, w_neg)
    rb_pos = torch.where(at_hi, torch.full_like(k, (1 << f.rcap) - 1),
                         ((1 << (k.clamp(min=0) + 1)) - 1) << 1)
    rb_neg = torch.where(at_lo, torch.zeros_like(k), torch.ones_like(k))
    regime_bits = torch.where(pos, rb_pos, rb_neg)
    frac_g = torch.round((mant - 1.0) * (2.0 ** G)).to(torch.int64)
    T = (e << G) | frac_g
    t = (N - 1) - w
    sh = es + G - t
    T_r = _rne_shift(T, sh)
    T_r = torch.where(sh < 0, T << (-sh).clamp(min=0), T_r)
    body = (regime_bits << t.clamp(min=0)) + T_r
    maxbody = _mask(N - 1)
    body = torch.clamp(body, 1, maxbody)
    body = torch.where(over, torch.full_like(body, maxbody), body)
    body = torch.where(under, torch.ones_like(body), body)
    pat = torch.where(sign, (-body) & _mask(N), body)
    pat = torch.where(is_zero, torch.zeros_like(pat), pat)
    return torch.where(is_nar, torch.full_like(pat, 1 << (N - 1)), pat)


def _leading_run(body, n: int, r0, depth: int):
    x = torch.where(r0 == 1, ~body, body) & _mask(n)
    _, e = torch.frexp(x.to(torch.float64))
    return torch.clamp(n - e.to(body.dtype), max=depth)


def fields(bits, f: Format):
    """Posit patterns -> (sign, scale, frac in the W-bit window, zero or
    NaR), integer fields int64."""
    N = f.n_bits
    p = bits.to(torch.int64) & _mask(N)
    sign = (p >> (N - 1)) & 1
    neg = (-p) & _mask(N)
    body = torch.where(sign == 1, neg & _mask(N - 1), p & _mask(N - 1))
    special = (p == 0) | (p == (1 << (N - 1)))
    r0 = (body >> (N - 2)) & 1
    run = _leading_run(body, N - 1, r0, N - 1)
    saturated = run >= f.rcap
    run_eff = torch.clamp(run, max=f.rcap)
    regime_width = torch.where(saturated, torch.full_like(run, f.rcap),
                               run_eff + 1)
    k = torch.where(r0 == 1, run_eff - 1, -run_eff)
    rem = (body << regime_width) & _mask(N - 1)
    if f.es > 0:
        e = rem >> (N - 1 - f.es)
        frac = rem & _mask(N - 1 - f.es)
    else:
        e = torch.zeros_like(k)
        frac = rem
    scale = torch.where(special, torch.zeros_like(k), k * (1 << f.es) + e)
    frac = torch.where(special, torch.zeros_like(frac), frac)
    return sign, scale, frac, special


def _clear_top_set_bits(x, k: int):
    for _ in range(k):
        nz = x != 0
        _, e = torch.frexp(torch.where(nz, x, torch.ones_like(x))
                           .to(torch.float64))
        pos = e.to(torch.int64) - 1
        x = torch.where(nz, x & ~(1 << pos), x)
    return x


def planes(x, f: Format):
    """The (val, rem) ILM planes of the values ``x`` (already divided by
    their pre-scale), float32."""
    sign, scale, frac, special = fields(encode(x, f), f)
    W = f.frac_window
    if f.trunc is not None and f.trunc < W:
        drop = W - f.trunc
        frac = (frac >> drop) << drop
    mant = (1 << W) | frac
    rem_mant = _clear_top_set_bits(mant, f.stages)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    unit = torch.where(sign == 1, -one, one) * pow2(scale - W)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    val = torch.where(special, zero, unit * mant.to(torch.float32))
    rem = torch.where(special, zero, unit * rem_mant.to(torch.float32))
    return val, rem
