"""Bit-accurate Posit / Bounded-Posit (B-Posit) codec on torch tensors.

Counterpart of ``repro.core.posit``: ``Posit(N, es)`` plus the bounded-regime
variant ``bPosit(N, es, R)`` (regime run capped at R bits; runs of length R
carry no terminator bit).

Representation notes
--------------------
* torch's CPU ``uint16``/``uint32`` tensors lack shifts and compares, so
  patterns are carried as ``int64`` masked to the low N bits.  Storage
  words are ``uint8`` (8-bit), ``int16`` (16-bit) or ``int32`` (32-bit),
  reinterpreted at the storage boundary (:func:`to_storage` /
  :func:`from_storage`).
* Negative posits are the two's complement of the whole word; ``body`` is
  the low N-1 bits of the non-negative pattern.
* Decode exposes integer fields ``(sign, scale, frac)`` with a fixed
  fraction window ``W = N - 1 - es``:
  ``value = (-1)^sign * 2^(scale - W) * (2^W + frac)``.
* Encode rounds to nearest even in the pattern domain, clamps to
  minpos/maxpos (no rounding to zero, no overflow), maps 0 to 0 and
  NaN/Inf to NaR.
* XLA flushes f32 and bf16 subnormals to zero, on its CPU runtime as on a
  TPU, so the reference encodes a subnormal input as 0, reads a
  subnormal dividend of a pre-scale ``x / s`` as 0, and a product of the
  codec's values that goes subnormal is a signed 0.  The port follows
  that rule (``encode_from_float``, :func:`flush_subnormals`,
  :func:`flushed_quotient`).
"""
from __future__ import annotations

import dataclasses

import torch

_GUARD = 26  # guard bits carried through encode; exact for float32 inputs
MIN_NORMAL = 2.0 ** -126  # the smallest normal float32 (and bfloat16)


@dataclasses.dataclass(frozen=True)
class PositConfig:
    """Static description of a (bounded) posit format."""

    n_bits: int
    es: int
    regime_max: int | None = None  # None => standard posit

    def __post_init__(self):
        if self.n_bits not in (8, 16, 32):
            raise ValueError(f"unsupported posit width {self.n_bits}")
        if self.regime_max is not None and not (1 <= self.regime_max <= self.n_bits - 1):
            raise ValueError("regime bound out of range")

    @property
    def bounded(self) -> bool:
        return self.regime_max is not None

    @property
    def rcap(self) -> int:
        """Maximum regime *run length*."""
        return self.regime_max if self.bounded else self.n_bits - 1

    @property
    def k_max(self) -> int:
        return (self.regime_max - 1) if self.bounded else self.n_bits - 2

    @property
    def k_min(self) -> int:
        return -self.regime_max if self.bounded else -(self.n_bits - 2)

    @property
    def frac_window(self) -> int:
        """Fixed decode fraction window W."""
        return self.n_bits - 1 - self.es

    @property
    def body_bits(self) -> int:
        return self.n_bits - 1

    @property
    def max_scale(self) -> int:
        if self.bounded:
            return self.k_max * (1 << self.es) + (1 << self.es) - 1
        return self.k_max * (1 << self.es)

    @property
    def min_scale(self) -> int:
        return self.k_min * (1 << self.es)

    @property
    def storage_dtype(self) -> torch.dtype:
        return STORAGE_DTYPES[f"uint{self.n_bits}"]

    @property
    def name(self) -> str:
        b = f",R{self.regime_max}" if self.bounded else ""
        return f"posit({self.n_bits},{self.es}{b})"


# The paper's operating points (Section II-B.3).
POSIT8 = PositConfig(8, 0)
POSIT16 = PositConfig(16, 1)
POSIT32 = PositConfig(32, 2)
BPOSIT8 = PositConfig(8, 0, 2)
BPOSIT16 = PositConfig(16, 1, 3)
BPOSIT32 = PositConfig(32, 2, 5)

BY_WIDTH = {8: (POSIT8, BPOSIT8), 16: (POSIT16, BPOSIT16), 32: (POSIT32, BPOSIT32)}

# Storage word dtype per unsigned word name.  16/32-bit words live in the
# signed dtype of the same width (same bytes; torch's unsigned 16/32-bit
# dtypes cannot be computed on).
STORAGE_DTYPES = {"uint8": torch.uint8, "uint16": torch.int16,
                  "uint32": torch.int32}
_STORAGE_WIDTH = {torch.uint8: 8, torch.int16: 16, torch.int32: 32}


def mask(nbits: int) -> int:
    return (1 << nbits) - 1


def exp2i(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e (float32) for integer e in [-126, 127], from exponent bits."""
    bits = (e.to(torch.int32).clamp(-126, 127) + 127) << 23
    return bits.view(torch.float32)


def flush_subnormals(t: torch.Tensor) -> torch.Tensor:
    """XLA's flush of a result: subnormal values become (signed) zero."""
    return torch.where(t.abs() < MIN_NORMAL, t * 0.0, t)


def flushed_quotient(x: torch.Tensor, s) -> torch.Tensor:
    """``x / s`` as XLA computes it: a subnormal ``x`` reads as 0 (a
    subnormal quotient needs no flush here: the encode takes it as 0)."""
    return flush_subnormals(x) / s


def pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e for |e| up to ~250 as two balanced exponent-field factors
    (the kernels' form, so results below 2^-126 agree)."""
    e = e.to(torch.int32)
    h1 = torch.div(e, 2, rounding_mode="floor")
    return exp2i(h1) * exp2i(e - h1)


def leading_run(body: torch.Tensor, n: int, r0: torch.Tensor,
                depth: int) -> torch.Tensor:
    """Length of the run of ``r0`` bits at the top of the ``n``-bit field
    ``body``, capped at ``depth``: ``n`` minus the bit length of the field
    with ``r0 == 1`` runs inverted (torch has no count-leading-zeros; the
    bit length comes from a float64 ``frexp``, exact below 2^53)."""
    x = torch.where(r0 == 1, ~body, body) & mask(n)
    _, e = torch.frexp(x.to(torch.float64))   # frexp(0) gives e = 0
    return torch.clamp(n - e.to(body.dtype), max=depth)


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------

def decode_fields(bits, cfg: PositConfig) -> dict:
    """Decode posit patterns to integer fields.

    Args:
      bits: integer tensor of patterns (low ``n_bits`` used).
    Returns:
      dict with ``sign`` (0/1), ``scale``, ``frac`` (fixed ``W``-bit
      window), ``is_zero``, ``is_nar`` and ``frac_window``; integer fields
      are int64.
    """
    N = cfg.n_bits
    p = torch.as_tensor(bits).to(torch.int64) & mask(N)
    sign = (p >> (N - 1)) & 1
    neg = (-p) & mask(N)
    body = torch.where(sign == 1, neg & mask(N - 1), p & mask(N - 1))

    is_zero = p == 0
    is_nar = p == (1 << (N - 1))

    # --- regime: the run of the leading bit, capped at N-1 (clz in JAX) ---
    r0 = (body >> (N - 2)) & 1
    run = leading_run(body, N - 1, r0, N - 1)
    rcap = cfg.rcap
    saturated = run >= rcap
    run_eff = torch.clamp(run, max=rcap)
    regime_width = torch.where(saturated, torch.full_like(run, rcap),
                               run_eff + 1)
    k = torch.where(r0 == 1, run_eff - 1, -run_eff)

    # --- exponent + fraction ---
    W = cfg.frac_window
    rem = (body << regime_width) & mask(N - 1)
    if cfg.es > 0:
        e = rem >> (N - 1 - cfg.es)
        frac = rem & mask(N - 1 - cfg.es)
    else:
        e = torch.zeros_like(k)
        frac = rem
    scale = k * (1 << cfg.es) + e
    special = is_zero | is_nar
    scale = torch.where(special, torch.zeros_like(scale), scale)
    frac = torch.where(special, torch.zeros_like(frac), frac)
    return dict(sign=sign, scale=scale, frac=frac, is_zero=is_zero,
                is_nar=is_nar, frac_window=W)


def decode_to_float(bits, cfg: PositConfig, dtype=torch.float32):
    """Decode posit patterns to floats (NaR -> NaN, 0 -> 0)."""
    f = decode_fields(bits, cfg)
    W = cfg.frac_window
    # arithmetic in ``dtype`` as the reference does (bf16 rounds here)
    mant = 1.0 + f["frac"].to(dtype) * (2.0 ** -W)
    val = mant * pow2(f["scale"]).to(dtype)
    val = torch.where(f["sign"] == 1, -val, val)
    val = torch.where(f["is_zero"], torch.zeros_like(val), val)
    val = torch.where(f["is_nar"], torch.full_like(val, float("nan")), val)
    return val.to(dtype)


# --------------------------------------------------------------------------
# Encode
# --------------------------------------------------------------------------

def _rne_shift(v, sh):
    """Round-to-nearest-even right shift of ``v`` by ``sh`` bits."""
    sh_u = torch.clamp(sh, 1, 31)
    half = (1 << (sh_u - 1)) - 1
    lsb = (v >> sh_u) & 1
    out = (v + half + lsb) >> sh_u
    return torch.where(sh <= 0, v, out)


def encode_from_float(x, cfg: PositConfig):
    """Encode a float tensor to posit patterns (int64, low n_bits valid);
    zero and subnormal inputs give 0 (XLA's flush)."""
    N, es, G = cfg.n_bits, cfg.es, _GUARD
    xf = torch.as_tensor(x).to(torch.float32)
    sign = torch.signbit(xf)
    a = xf.abs()
    finite = torch.isfinite(xf)
    is_zero = a < MIN_NORMAL
    is_nar = ~finite

    m, ex = torch.frexp(torch.where(is_zero | is_nar, torch.ones_like(a), a))
    scale = ex.to(torch.int64) - 1
    mant = m * 2.0  # [1, 2)

    over = scale > cfg.max_scale
    under = scale < cfg.min_scale
    scale_c = torch.clamp(scale, cfg.min_scale, cfg.max_scale)
    mant = torch.where(over | under, torch.ones_like(mant), mant)

    k = scale_c >> es  # arithmetic shift = floor division
    e = scale_c - k * (1 << es)

    kmax, kmin, rcap = cfg.k_max, cfg.k_min, cfg.rcap
    pos = k >= 0
    at_hi = k == kmax
    at_lo = k == kmin
    if cfg.bounded:
        w_pos = torch.where(at_hi, torch.full_like(k, rcap), k + 2)
        w_neg = torch.where(at_lo, torch.full_like(k, rcap), -k + 1)
    else:
        w_pos = torch.where(at_hi, torch.full_like(k, N - 1), k + 2)
        w_neg = -k + 1
    w = torch.where(pos, w_pos, w_neg)

    rb_hi = (1 << (rcap if cfg.bounded else N - 1)) - 1
    rb_pos = torch.where(at_hi, torch.full_like(k, rb_hi),
                         ((1 << (k.clamp(min=0) + 1)) - 1) << 1)
    if cfg.bounded:
        rb_neg = torch.where(at_lo, torch.zeros_like(k), torch.ones_like(k))
    else:
        rb_neg = torch.ones_like(k)
    regime_bits = torch.where(pos, rb_pos, rb_neg)

    # tail = exponent + fraction at G guard bits, rounded into t payload bits
    frac_g = torch.round((mant - 1.0) * (2.0 ** G)).to(torch.int64)
    T = (e << G) | frac_g
    t = (N - 1) - w
    sh = es + G - t
    T_r = _rne_shift(T, sh)
    T_r = torch.where(sh < 0, T << (-sh).clamp(min=0), T_r)

    body = (regime_bits << t.clamp(min=0)) + T_r
    maxbody = mask(N - 1)
    body = torch.clamp(body, 1, maxbody)
    body = torch.where(over, torch.full_like(body, maxbody), body)
    body = torch.where(under, torch.ones_like(body), body)

    pat = torch.where(sign, (-body) & mask(N), body)
    pat = torch.where(is_zero, torch.zeros_like(pat), pat)
    pat = torch.where(is_nar, torch.full_like(pat, 1 << (N - 1)), pat)
    return pat


_QUANT_CHUNK = 1 << 24


def quantize(x, cfg: PositConfig, dtype=torch.float32):
    """Round floats to the nearest posit value (roundtrip through the codec).

    Tensors above ``_QUANT_CHUNK`` elements go through the codec a chunk of
    the flattened tensor at a time, so the codec's int64 temporaries stay a
    few hundred MB (a gemma2-2b head is 590 M values); the result is
    elementwise and identical."""
    x = torch.as_tensor(x)
    n = x.numel()
    if n <= _QUANT_CHUNK:
        return decode_to_float(encode_from_float(x, cfg), cfg, dtype)
    flat = x.reshape(-1)
    out = torch.empty(n, dtype=dtype, device=x.device)
    for c0 in range(0, n, _QUANT_CHUNK):
        part = flat[c0:c0 + _QUANT_CHUNK]
        out[c0:c0 + _QUANT_CHUNK] = decode_to_float(
            encode_from_float(part, cfg), cfg, dtype)
    return out.reshape(x.shape)


def storage_pc(dtype, preferred: PositConfig | None = None) -> PositConfig | None:
    """Posit format implied by a storage dtype, honoring a preferred format.

    Returns ``preferred`` when its word width matches the storage width,
    else the standard posit of that width; ``None`` for float storage.
    """
    width = _STORAGE_WIDTH.get(dtype)
    if width is None:
        return None
    if preferred is not None and preferred.n_bits == width:
        return preferred
    return BY_WIDTH[width][0]


def to_storage(pat, cfg: PositConfig):
    """int64 patterns -> storage words (two's-complement wrap for the signed
    16/32-bit storage dtypes keeps the bytes of the unsigned word)."""
    N = cfg.n_bits
    p = pat & mask(N)
    if N < 64 and cfg.storage_dtype != torch.uint8:
        p = torch.where(p >= (1 << (N - 1)), p - (1 << N), p)
    return p.to(cfg.storage_dtype)


def from_storage(arr, cfg: PositConfig):
    """Storage words -> int64 patterns masked to N bits."""
    return torch.as_tensor(arr).to(torch.int64) & mask(cfg.n_bits)


# --------------------------------------------------------------------------
# Pure-Python big-int reference codec (oracle for tests; exact for any width)
# --------------------------------------------------------------------------

def np_decode(pattern: int, cfg: PositConfig) -> float:
    """Exact decode of one pattern with Python ints (NaR -> nan)."""
    N, es = cfg.n_bits, cfg.es
    p = int(pattern) & ((1 << N) - 1)
    if p == 0:
        return 0.0
    if p == 1 << (N - 1):
        return float("nan")
    sign = p >> (N - 1)
    body = ((1 << N) - p if sign else p) & ((1 << (N - 1)) - 1)
    bits = [(body >> (N - 2 - i)) & 1 for i in range(N - 1)]
    r0 = bits[0]
    run = 0
    for b in bits:
        if b == r0 and run < cfg.rcap:
            run += 1
        else:
            break
    if run >= cfg.rcap:
        rw, k = cfg.rcap, (cfg.rcap - 1 if r0 else -cfg.rcap)
    else:
        rw, k = run + 1, (run - 1 if r0 else -run)
    rest = bits[rw:] + [0] * (es + 64)
    e = 0
    for i in range(es):
        e = (e << 1) | rest[i]
    W = N - 1 - es
    frac = 0
    for i in range(W):
        frac = (frac << 1) | rest[es + i]
    scale = k * (1 << es) + e
    val = (1 + frac / (1 << W)) * (2.0 ** scale)
    return -val if sign else val


def np_encode(x: float, cfg: PositConfig) -> int:
    """Exact reference encode using Python big ints (value-domain fields,
    pattern-domain RNE like the tensor path)."""
    import math

    N, es = cfg.n_bits, cfg.es
    if x == 0:
        return 0
    if not math.isfinite(x):
        return 1 << (N - 1)
    sign = x < 0
    a = abs(x)
    mant, ex = math.frexp(a)  # mant in [0.5, 1)
    scale = ex - 1
    mant *= 2.0
    over, under = scale > cfg.max_scale, scale < cfg.min_scale
    scale = min(max(scale, cfg.min_scale), cfg.max_scale)
    if over or under:
        mant = 1.0
    k = scale >> es
    e = scale - (k << es)
    if cfg.bounded:
        w = cfg.rcap if k in (cfg.k_max, cfg.k_min) else (k + 2 if k >= 0 else -k + 1)
        if k >= 0:
            rb = (1 << cfg.rcap) - 1 if k == cfg.k_max else (((1 << (k + 1)) - 1) << 1)
        else:
            rb = 0 if k == cfg.k_min else 1
    else:
        w = N - 1 if k == cfg.k_max else (k + 2 if k >= 0 else -k + 1)
        rb = ((1 << (N - 1)) - 1) if k == cfg.k_max else ((((1 << (k + 1)) - 1) << 1) if k >= 0 else 1)
    G = 56
    frac_g = int(round((mant - 1.0) * (1 << G)))
    T = (e << G) | frac_g
    t = (N - 1) - w
    sh = es + G - t
    if sh > 0:
        lsb = (T >> sh) & 1
        T = (T + ((1 << (sh - 1)) - 1) + lsb) >> sh
    elif sh < 0:
        T <<= -sh
    body = (rb << max(t, 0)) + T
    body = min(max(body, 1), (1 << (N - 1)) - 1)
    if over:
        body = (1 << (N - 1)) - 1
    if under:
        body = 1
    return ((1 << N) - body) & ((1 << N) - 1) if sign else body
