"""Fused logarithmic-posit MAC matmul: the CUDA kernel and its plain version.

``decode_planes_raw`` turns posit patterns into (val, rem) f32 ILM planes
with the kernels' arithmetic: a regime scan of fixed depth ``rcap``, m /
sub-lane truncation, clearing the top ``stages`` set bits, and 2^e built
as two exponent-field factors.  ``logmac`` multiplies ``(M,K)`` by
``(K,N)`` pattern matrices into the f32 ``(M,N)`` "quire" value
``sum va*vb - sum ra*rb``: the plain version for CPU tensors, the
``csrc/logmac.cu`` kernel for CUDA tensors.

As in the TPU kernel (``repro/kernels/logmac.py:144``), the rem dot is
subtracted only when ``stages > 0`` and the mode is ``euler``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import posit as P
from repro_torch.core.engine import EulerConfig
from repro_torch.core.logmult import effective_trunc, leading_one_pos
from . import _build

M = P.mask


def _clear_top_bits(x, k: int):
    for _ in range(k):
        nz = x > 0
        pos = leading_one_pos(torch.where(nz, x, torch.ones_like(x)))
        x = torch.where(nz, x & ~(1 << pos), x)
    return x


def decode_planes_raw(pat, pc: P.PositConfig, stages: int,
                      trunc: int | None, sublane: int | None):
    """Posit patterns -> (val, rem) f32 ILM planes (pure tensor ops)."""
    N, es, W = pc.n_bits, pc.es, pc.frac_window
    rcap = pc.rcap
    p = torch.as_tensor(pat).to(torch.int64) & M(N)
    sign = (p >> (N - 1)) & 1
    body = torch.where(sign == 1, (-p) & M(N - 1), p & M(N - 1))
    is_special = (p == 0) | (p == (1 << (N - 1)))

    r0 = (body >> (N - 2)) & 1
    # the regime run, capped at rcap (the kernels' fixed-depth scan)
    run = P.leading_run(body, N - 1, r0, rcap)
    sat = run >= rcap
    rw = torch.where(sat, torch.full_like(run, rcap), run + 1)
    k = torch.where(r0 == 1, run - 1, -run)

    rem_bits = (body << rw) & M(N - 1)
    if es > 0:
        e = rem_bits >> (N - 1 - es)
        frac = rem_bits & M(N - 1 - es)
    else:
        e = torch.zeros_like(k)
        frac = rem_bits
    scale = k * (1 << es) + e

    m = effective_trunc(trunc, sublane)
    if m is not None and m < W:
        drop = W - m
        frac = (frac >> drop) << drop

    mant = (1 << W) | frac
    rem_mant = _clear_top_bits(mant, stages)

    one = torch.ones((), dtype=torch.float32, device=p.device)
    sgn = torch.where(sign == 1, -one, one)
    unit = sgn * P.pow2(scale - W)
    val = unit * mant.to(torch.float32)
    rem = unit * rem_mant.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=p.device)
    return (torch.where(is_special, zero, val),
            torch.where(is_special, zero, rem))


def decode_planes(pat, ecfg: EulerConfig):
    return decode_planes_raw(pat, ecfg.posit, ecfg.stages, ecfg.trunc,
                             ecfg.sublane)


def subtracts_rem(ecfg: EulerConfig) -> bool:
    return ecfg.stages > 0 and ecfg.mode == "euler"


def logmac_plain(a_pat, b_pat, ecfg: EulerConfig,
                 n_chunk: int = 16384) -> torch.Tensor:
    """The plain version of the logmac kernel (f32 dots at full precision).

    B is decoded ``n_chunk`` columns at a time so the int64 temporaries of
    a 256k-column head stay a few hundred MB."""
    va, ra = decode_planes(a_pat, ecfg)
    sub = subtracts_rem(ecfg)
    outs = []
    for c0 in range(0, b_pat.shape[1], n_chunk):
        vb, rb = decode_planes(b_pat[:, c0:c0 + n_chunk], ecfg)
        acc = va @ vb
        if sub:
            acc = acc - ra @ rb
        outs.append(acc)
    if not outs:
        return torch.zeros(a_pat.shape[0], 0, device=a_pat.device)
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def logmac(a_pat: torch.Tensor, b_pat: torch.Tensor,
           ecfg: EulerConfig) -> torch.Tensor:
    """(M,K) x (K,N) posit patterns -> (M,N) f32 ILM product."""
    Mr, K = a_pat.shape
    K2, Nc = b_pat.shape
    if K != K2:
        raise ValueError(f"logmac: contraction mismatch {a_pat.shape} x "
                         f"{b_pat.shape}")
    if a_pat.device.type == "cpu" and b_pat.device.type == "cpu":
        return logmac_plain(a_pat, b_pat, ecfg)
    for t, n in ((a_pat, "a"), (b_pat, "b")):
        if t.device.type != "cuda":
            raise ValueError(f"logmac: operand {n} on {t.device}; both "
                             "operands must be on one CUDA device")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"logmac: operand {n} must be contiguous int32 "
                             f"words (got {t.dtype})")
    if ecfg.mode != "euler":
        raise ValueError(f"logmac kernel runs euler mode, got {ecfg.mode}")
    pc = ecfg.posit
    m = effective_trunc(ecfg.trunc, ecfg.sublane)
    out = torch.empty((Mr, Nc), dtype=torch.float32, device=a_pat.device)
    lib = _build.load("logmac")
    fn = lib.logmac_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(a_pat.data_ptr(), b_pat.data_ptr(), out.data_ptr(), Mr, Nc, K,
             pc.n_bits, pc.es, pc.regime_max or 0, ecfg.stages,
             -1 if m is None else m, int(subtracts_rem(ecfg)),
             _build.stream_ptr(a_pat))
    _build.check(err, "logmac")
    _build.count_launch("logmac", pc.n_bits)
    return out
