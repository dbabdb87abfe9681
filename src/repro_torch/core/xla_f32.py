"""float32 elementwise functions that round as XLA:CPU's do.

The JAX models' transcendental functions lower, on XLA:CPU, to polynomial
approximations that LLVM compiles with fused multiply-adds wherever an
``fadd``/``fsub`` reads a multiply that has no other use.  torch's CPU
kernels (SLEEF, libm) round differently in a few percent of values, and
under L-21b a one-ulp difference can move a quantized operand across a
posit rounding boundary, so whole-model gradients drift apart.  These
functions transcribe XLA's approximations op for op (constants, clamps,
range reduction and the contracted multiply-adds, each emulated exactly as
the float64 ``a*b + c`` rounded once to float32) and give XLA's bits:

  ``exp``       exp's Cephes-style polynomial (2^n by the exponent field)
  ``logistic``  ``1 / (1 + exp(-x))``, the add fused with exp's last multiply
  ``silu``      ``x * logistic(x)``
  ``gelu_tanh`` ``jax.nn.gelu(x, approximate=True)``
  ``tanh``      the odd rational approximation, clamped at +-7.99881
  ``log``       the Cephes-style log, ``log1p`` (the rational form below
                sqrt(2) - 1) and ``softplus`` (``jnp.logaddexp(x, 0)``)
  ``sum_last``  a sum over the last axis in XLA:CPU's order: left to right
                up to 32 terms; a longer row in windows of 32 (each left to
                right), whose sums are added the same way; ``mean_last``
                multiplies that by 1/n
  ``prefix_sum`` ``jnp.cumsum``: XLA:CPU's reduce-window prefix sum, left to
                right up to 32 terms (the SSD's chunks are 8-16 in the tests;
                XLA rewrites longer windows, which this does not follow)
  ``rsqrt``     NOT matched: XLA refines the host CPU's ``rsqrtps``
                estimate (a table of the CPU model) by two Newton steps;
                here the same two steps refine the correctly rounded
                ``1/sqrt``, which agrees with XLA in most but not all values

Each has JAX's derivative rule (``jax/_src/lax/lax.py``), so that the
backward pass multiplies in JAX's order, too, as XLA:CPU compiles it where
the dumped vjp shows its own fused form (tanh, silu, gelu).

The port's models call the functions at the end of this module (``exp``,
``tanh``, ``silu``, ...), one helper per function: on CPU tensors, where the
tests compare the port with the JAX package, they take these transcriptions;
on the card they are torch's own functions, so the host-bound decode paths
get no extra launches (a transcription is some twenty torch ops).
"""
from __future__ import annotations

import struct

import torch
import torch.nn.functional as F

# XLA's kernels flush subnormal results to (signed) zero
from repro_torch.core.posit import MIN_NORMAL as _MIN_NORMAL
from repro_torch.core.posit import flush_subnormals as _ftz


def _h(hexd: str) -> float:
    """The float32 value of an LLVM IR hex float constant (a double)."""
    return struct.unpack(">d", bytes.fromhex(hexd))[0]


def _f(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _fma(a, b, c) -> torch.Tensor:
    """float32 fused multiply-add: the float64 ``a*b + c`` rounded once to
    float32 (the product of two float32 values is exact in float64)."""
    def d(t):
        return t.double() if isinstance(t, torch.Tensor) else t
    return (d(a) * d(b) + d(c)).to(torch.float32)


# exp: clamp to [LO, HI], n = floor(x log2 e + 1/2), x - n ln 2 in two
# parts, a degree-5 polynomial, then 2^n from the exponent field
_EXP_LO, _EXP_HI = _h("C055F33340000000"), _h("4056333340000000")
_LOG2E = _h("3FF7154760000000")
_LN2_HI, _LN2_LO = _h("3FE6300000000000"), _h("BF2BD01060000000")
_EXP_P = [_h("3F2A0D2CE0000000"), _h("3F56E879C0000000"),
          _h("3F81112100000000"), _h("3FA5553820000000"),
          _h("3FC5555540000000"), 0.5]


def _exp_parts(x: torch.Tensor):
    """exp(x) as (y, 2^n) with exp(x) = y * 2^n rounded once."""
    x = x.to(torch.float32)
    nan = torch.isnan(x)
    a = torch.where((x >= _EXP_LO) | nan, x, _f(_EXP_LO, x))
    a = torch.where((a <= _EXP_HI) | nan, a, _f(_EXP_HI, x))
    n = torch.floor(_fma(a, _LOG2E, 0.5)).clamp(-127.0, 127.0)
    a = _fma(-n, _LN2_HI, a)
    a = _fma(-n, _LN2_LO, a)
    y = _fma(a, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        y = _fma(y, a, c)
    y = _fma(y, a * a, a) + 1.0
    p2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return y, p2


def exp_fwd(x: torch.Tensor) -> torch.Tensor:
    y, p2 = _exp_parts(x)
    return _ftz(y * p2)


def logistic_fwd(x: torch.Tensor) -> torch.Tensor:
    y, p2 = _exp_parts(-x.to(torch.float32))
    return _ftz(1.0 / _fma(y, p2, 1.0))


# tanh: x for |x| < 4e-4, +-1 for |x| >= 20, else p(x)/q(x) of x clamped
# to +-7.99881
_TANH_SMALL, _TANH_CLAMP = _h("3F3A36E2E0000000"), _h("401FFEC880000000")
_TANH_P = [_h("BCB3E4B800000000"), _h("3D4C266FC0000000"),
           _h("BDD7A6FFE0000000"), _h("3E6B800820000000"),
           _h("3EEF286940000000"), _h("3F44E1BDA0000000"),
           _h("3F740B3B80000000")]
_TANH_Q = [_h("3EB41A7B00000000"), _h("3F1F12BAC0000000"),
           _h("3F629540A0000000"), _h("3F740B3BA0000000")]


def tanh_fwd(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    ax = x.abs()
    c = torch.where(x < -_TANH_CLAMP, _f(-_TANH_CLAMP, x), x)
    c = torch.where(c > _TANH_CLAMP, _f(_TANH_CLAMP, x), c)
    x2 = c * c
    p = _fma(x2, _TANH_P[0], _TANH_P[1])
    for k in _TANH_P[2:]:
        p = _fma(x2, p, k)
    q = _fma(x2, _TANH_Q[0], _TANH_Q[1])
    for k in _TANH_Q[2:]:
        q = _fma(x2, q, k)
    r = torch.where(ax < _TANH_SMALL, x, (c * p) / q)
    return torch.where(ax >= 20.0, torch.copysign(_f(1.0, x), x), r)


# log: x = m 2^e with m in [sqrt(1/2), sqrt(2)), three interleaved Horner
# chains in m - 1, then e ln 2 in two parts
_SQRT_HALF = _h("3FE6A09E60000000")
_LOG_A = [_h("3FB2043760000000"), _h("BFBD7A3700000000"),
          _h("3FBDE4A340000000")]
_LOG_B = [_h("BFBFCBA9E0000000"), _h("3FC23D37E0000000"),
          _h("BFC555CA00000000")]
_LOG_C = [_h("3FC999D580000000"), _h("BFCFFFFF80000000"),
          _h("3FD5555540000000")]


def log_fwd(x: torch.Tensor) -> torch.Tensor:
    x = _ftz(x.to(torch.float32))     # XLA reads subnormal inputs as zero
    a = torch.where((x <= _MIN_NORMAL) | torch.isnan(x),
                    _f(_MIN_NORMAL, x), x)
    bits = a.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & -0x7F800001) | 0x3F000000).view(torch.float32)
    lt = m < _SQRT_HALF
    e = e - lt.to(torch.float32)
    m = (m - 1.0) + torch.where(lt, m, _f(0.0, x))
    m2 = m * m
    m3 = m2 * m
    A = _fma(_fma(m, _LOG_A[0], _LOG_A[1]), m, _LOG_A[2])
    B = _fma(_fma(m, _LOG_B[0], _LOG_B[1]), m, _LOG_B[2])
    C = _fma(_fma(m, _LOG_C[0], _LOG_C[1]), m, _LOG_C[2])
    y = _fma(_fma(A, m3, B), m3, C)
    y = _fma(y, m3, _LN2_LO * e)
    y = _fma(_LN2_HI, e, (m - 0.5 * m2) + y)
    y = torch.where(x < 0, _f(float("nan"), x), y)
    y = torch.where(x == 0, _f(float("-inf"), x), y)
    y = torch.where(x == float("inf"), x, y)
    return torch.where(torch.isnan(x), x, y)


_LOG1P_SMALL = _h("3FDA8279A0000000")
_LOG1P_D = [_h("402E2035A0000000"), _h("4054C30B60000000"),
            _h("406BB865A0000000"), _h("4073519460000000"),
            _h("406B0DB140000000"), _h("404E0F3040000000")]
_LOG1P_N = [_h("3F07BC0960000000"), _h("3FDFE818A0000000"),
            _h("401A509F40000000"), _h("403DE97380000000"),
            _h("404E798EC0000000"), _h("404C8E75A0000000"),
            _h("40340A2020000000")]


def log1p_fwd(x: torch.Tensor) -> torch.Tensor:
    x = _ftz(x.to(torch.float32))
    x2 = x * x
    d = _fma(x, 0.0, 1.0)
    for k in _LOG1P_D:
        d = _fma(d, x, k)
    n = _fma(x, 0.0, _LOG1P_N[0])
    for k in _LOG1P_N[1:]:
        n = _fma(n, x, k)
    small = x + (x2 * -0.5 + (x * x2) * (n / d))
    return torch.where(x.abs() < _LOG1P_SMALL, small, log_fwd(x + 1.0))


def softplus_fwd(x: torch.Tensor) -> torch.Tensor:
    """``jnp.logaddexp(x, 0)``: max(x, 0) + log1p(exp(-|x|))."""
    x = x.to(torch.float32)
    out = torch.clamp(x, min=0.0) + log1p_fwd(exp_fwd(-x.abs()))
    return torch.where(torch.isnan(x), x, out)


def rsqrt_fwd(x: torch.Tensor) -> torch.Tensor:
    """XLA's two Newton steps on a start value (see the module docstring:
    XLA starts from the CPU's ``rsqrtps`` estimate, here from the correctly
    rounded 1/sqrt); positive normal inputs only are refined, as XLA's."""
    x = x.to(torch.float32)
    y0 = (1.0 / torch.sqrt(x.double())).to(torch.float32)
    y = y0
    for _ in range(2):
        y = _fma(y * -0.5, _fma(x * y, y, -1.0), y)
    normal = (x >= _MIN_NORMAL) & (x < float("inf"))
    return torch.where(normal | torch.isnan(x), y, y0)


# --------------------------------------------------------------------------
# autograd: JAX's derivative rules
# --------------------------------------------------------------------------

class _Exp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = exp_fwd(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * y                       # mul(g, ans)


class _Tanh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = tanh_fwd(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        # (g + g*ans) * (1 - ans), as XLA distributes and fuses it
        b = g * (1.0 - y)
        return _fma(y, b, b)


class _Silu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        s = logistic_fwd(x)
        ctx.save_for_backward(x, s)
        return _ftz(x * s)

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        # g*s + (g*x) * (s*(1 - s)), the first product fused
        return _fma(g, s, (x * g) * (s * (1.0 - s)))


# gelu (tanh form): x * ((tanh(c (x + k1 x^3)) + 1) / 2); k2 = c k1
_GELU_C, _GELU_K1 = _h("3FE9884540000000"), _h("3FA6E4E260000000")
_GELU_K2 = _h("3FA2444F20000000")


def _gelu_tanh_inner(x):
    x2 = x * x
    return x2, tanh_fwd(_fma(x * x2, _GELU_K1, x) * _GELU_C)


class _GeluTanh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.to(torch.float32)
        ctx.save_for_backward(x)
        _, t = _gelu_tanh_inner(x)
        return _ftz(x * ((t + 1.0) * 0.5))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        x2, t = _gelu_tanh_inner(x)
        b = ((x * g) * 0.5) * (1.0 - t)
        s = _fma(t, b, b)
        return _fma(x2 * 3.0, s * _GELU_K2,
                    _fma(g, (t + 1.0) * 0.5, s * _GELU_C))


class _Log(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return log_fwd(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g / x                       # div(g, x)


class _Softplus(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = softplus_fwd(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        # logaddexp's jvp: t1 * exp(x1 - out)
        return g * exp_fwd(x - y)


class _Rsqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = rsqrt_fwd(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * (-0.5 * (y / x))        # mul(g, mul(-0.5, div(ans, x)))


class _Cumsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _prefix(x, dim, reverse=False)

    @staticmethod
    def backward(ctx, g):
        # cumsum's transpose: the reversed prefix sum
        return _prefix(g, ctx.dim, reverse=True), None


def _prefix(x: torch.Tensor, dim: int, reverse: bool) -> torch.Tensor:
    """Inclusive prefix sum along ``dim`` as XLA's reduce-window computes
    it: each output sums its window [0, i] (reverse: [i, n)) left to
    right."""
    n = x.shape[dim]
    out = torch.empty_like(x)
    if not reverse:
        acc = x.select(dim, 0)
        out.select(dim, 0).copy_(acc)
        for i in range(1, n):
            acc = acc + x.select(dim, i)
            out.select(dim, i).copy_(acc)
        return out
    for i in range(n):
        acc = x.select(dim, i)
        for j in range(i + 1, n):
            acc = acc + x.select(dim, j)
        out.select(dim, i).copy_(acc)
    return out


def prefix_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.cumsum(x, dim)`` in XLA:CPU's order (CPU tensors)."""
    return _Cumsum.apply(x, dim)


def sum_last(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sum(x, -1, keepdims=True)`` in XLA:CPU's order (rows of up to
    32, or of a multiple of 32, as its tree-reduction rewrite splits them);
    differentiable (a sum's cotangent is broadcast exactly)."""
    n = x.shape[-1]
    if n > 32:
        if n % 32:
            return x.sum(-1, keepdim=True)
        return sum_last(torch.cat([sum_last(x[..., w0:w0 + 32])
                                   for w0 in range(0, n, 32)], -1))
    tot = x[..., :1]
    for i in range(1, n):
        tot = tot + x[..., i:i + 1]
    return tot


class _Recip(torch.autograd.Function):
    """x * (1/n), the cotangent times the same float32 1/n."""
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x * _f(1.0 / n, x)

    @staticmethod
    def backward(ctx, g):
        return g * _f(1.0 / ctx.n, g), None


# --------------------------------------------------------------------------
# the functions the models call: XLA's roundings on CPU tensors, torch's
# own functions on the card
# --------------------------------------------------------------------------

def _cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def exp(x: torch.Tensor) -> torch.Tensor:
    return _Exp.apply(x) if _cpu(x) else torch.exp(x)


def log(x: torch.Tensor) -> torch.Tensor:
    return _Log.apply(x) if _cpu(x) else torch.log(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return _Tanh.apply(x) if _cpu(x) else torch.tanh(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)``."""
    return _Silu.apply(x) if _cpu(x) else F.silu(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``."""
    return _GeluTanh.apply(x) if _cpu(x) else F.gelu(x, approximate="tanh")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``jnp.logaddexp(x, 0)``."""
    return _Softplus.apply(x) if _cpu(x) else F.softplus(x)


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    return _Rsqrt.apply(x) if _cpu(x) else torch.rsqrt(x)


def mean_last(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(x, -1, keepdims=True)``: the sum times 1/n."""
    if not _cpu(x):
        return torch.mean(x, -1, keepdim=True)
    return _Recip.apply(sum_last(x), x.shape[-1])


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.softmax``: exp(x - max) over its sum."""
    if not _cpu(x):
        return torch.softmax(x, dim=dim)
    e = exp(x - x.amax(dim, keepdim=True).detach())
    return e / e.sum(dim, keepdim=True)


def logsumexp(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.scipy.special.logsumexp``: log(sum(exp(x - max))) + max, the
    max outside the gradient (0 where it is not finite)."""
    if not _cpu(x):
        return torch.logsumexp(x, dim)
    amax = x.amax(dim, keepdim=True).detach()
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    s = exp(x - amax).sum(dim)
    return log(s.abs()) + amax.squeeze(dim)
