"""Posit encode and decode: the CUDA kernels and their plain versions.

``encode_body`` builds each pattern straight from the f32 bit fields (no
frexp) with pattern-domain RNE, exactly like ``repro.kernels.posit_codec``:
subnormal inputs flush to zero (DAZ) and Inf/NaN map to NaR.
``posit_encode`` is the wrapper: plain version for a CPU tensor, the
``csrc/posit_encode.cu`` kernel for a CUDA tensor.

``posit_decode`` maps words to f32 through the ILM ``val`` plane
(``decode_planes_raw`` with stages 0), like the TPU decode kernel: zero and
NaR both decode to 0.0 and the mantissa is converted to f32 before it is
scaled.  That is not the core codec's ``decode_to_float`` (NaR -> NaN), so
no caller of the core codec is routed here; ``ops.decode`` is its entry.

Patterns come back as ``int32`` tensors holding the uint32 word's bits (low
N bits valid); the plain version's int64 result is narrowed the same way.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import posit as P
from . import _build
from .logmac import decode_planes_raw

_G = 26  # guard bits (>= 23 keeps f32 inputs exact)
M = P.mask


def encode_body(x, pc: P.PositConfig) -> torch.Tensor:
    """f32 -> posit pattern (int64, low N bits), pure integer tensor ops."""
    N, es, G = pc.n_bits, pc.es, _G
    bits = torch.as_tensor(x).to(torch.float32).contiguous().view(
        torch.int32).to(torch.int64) & M(32)
    sign = bits >> 31
    expf = (bits >> 23) & 0xFF
    frac23 = bits & M(23)
    is_zero = expf == 0                         # zero and subnormals (DAZ)
    is_nar = expf == 255                        # Inf/NaN -> NaR
    scale = expf - 127

    over = scale > pc.max_scale
    under = scale < pc.min_scale
    scale_c = torch.clamp(scale, pc.min_scale, pc.max_scale)
    frac_g = torch.where(over | under, torch.zeros_like(frac23),
                         frac23 << (G - 23))

    k = scale_c >> es
    e = scale_c - k * (1 << es)
    kmax, kmin, rcap = pc.k_max, pc.k_min, pc.rcap
    pos = k >= 0
    at_hi, at_lo = k == kmax, k == kmin
    full = torch.full_like
    rb_mid = ((1 << (k.clamp(min=0) + 1)) - 1) << 1
    if pc.bounded:
        w = torch.where(pos, torch.where(at_hi, full(k, rcap), k + 2),
                        torch.where(at_lo, full(k, rcap), -k + 1))
        rb = torch.where(pos, torch.where(at_hi, full(k, M(rcap)), rb_mid),
                         torch.where(at_lo, full(k, 0), full(k, 1)))
    else:
        w = torch.where(pos, torch.where(at_hi, full(k, N - 1), k + 2), -k + 1)
        rb = torch.where(pos, torch.where(at_hi, full(k, M(N - 1)), rb_mid),
                         full(k, 1))
    T = (e << G) | frac_g
    t = (N - 1) - w
    sh = es + G - t
    sh_u = torch.clamp(sh, 1, 31)
    half = (1 << (sh_u - 1)) - 1
    lsb = (T >> sh_u) & 1
    T_r = torch.where(sh > 0, (T + half + lsb) >> sh_u,
                      T << torch.clamp(-sh, 0, 31))
    body = (rb << t.clamp(min=0)) + T_r
    body = torch.clamp(body, 1, M(N - 1))
    body = torch.where(over, full(body, M(N - 1)), body)
    body = torch.where(under, full(body, 1), body)
    pat = torch.where(sign == 1, (-body) & M(N), body)
    pat = torch.where(is_zero, full(pat, 0), pat)
    pat = torch.where(is_nar, full(pat, 1 << (N - 1)), pat)
    return pat


def as_word32(pat: torch.Tensor) -> torch.Tensor:
    """int64 patterns -> int32 tensor with the uint32 word's bits."""
    p = pat & M(32)
    return torch.where(p >= (1 << 31), p - (1 << 32), p).to(torch.int32)


def encode_plain(x, pc: P.PositConfig) -> torch.Tensor:
    """The plain version of the encode kernel: int32 words."""
    return as_word32(encode_body(x, pc))


def posit_encode(x: torch.Tensor, pc: P.PositConfig) -> torch.Tensor:
    """f32 tensor -> posit words (int32 holding uint32 bits), any shape."""
    if x.device.type == "cpu":
        return encode_plain(x, pc)
    if x.device.type != "cuda":
        raise ValueError(f"posit_encode: unsupported device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("posit_encode: kernel takes contiguous float32 input "
                         f"(got {x.dtype}, contiguous={x.is_contiguous()})")
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    lib = _build.load("posit_encode")
    fn = lib.posit_encode_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), out.data_ptr(), x.numel(), pc.n_bits, pc.es,
             pc.regime_max or 0, _build.stream_ptr(x))
    _build.check(err, "posit_encode")
    _build.count_launch("posit_encode", pc.n_bits)
    return out


def decode_plain(pat, pc: P.PositConfig) -> torch.Tensor:
    """The plain version of the decode kernel: f32 values (0 and NaR -> 0)."""
    val, _ = decode_planes_raw(pat, pc, 0, None, None)
    return val


def posit_decode(pat: torch.Tensor, pc: P.PositConfig) -> torch.Tensor:
    """Posit words (int32 holding uint32 bits, low N valid) -> f32, any
    shape."""
    if pat.device.type == "cpu":
        return decode_plain(pat, pc)
    if pat.device.type != "cuda":
        raise ValueError(f"posit_decode: unsupported device {pat.device}")
    if pat.dtype != torch.int32 or not pat.is_contiguous():
        raise ValueError("posit_decode: kernel takes contiguous int32 words "
                         f"(got {pat.dtype}, "
                         f"contiguous={pat.is_contiguous()})")
    out = torch.empty(pat.shape, dtype=torch.float32, device=pat.device)
    lib = _build.load("posit_decode")
    fn = lib.posit_decode_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(pat.data_ptr(), out.data_ptr(), pat.numel(), pc.n_bits, pc.es,
             pc.regime_max or 0, _build.stream_ptr(pat))
    _build.check(err, "posit_decode")
    _build.count_launch("posit_decode", pc.n_bits)
    return out
