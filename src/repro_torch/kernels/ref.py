"""Oracles for every kernel of the port (counterparts of
``repro.kernels.ref``), built on the core codec and ILM planes."""
from __future__ import annotations

import torch

from repro_torch.core import logmult as LM
from repro_torch.core import posit as P
from repro_torch.core.engine import EulerConfig


def ref_decode(pat, cfg: P.PositConfig, dtype=torch.float32):
    """Oracle for the posit decode kernel (NaR -> NaN, where the kernel
    writes 0)."""
    return P.decode_to_float(pat, cfg, dtype)


def ref_encode(x, cfg: P.PositConfig):
    """Oracle for the posit encode kernel (int64 patterns)."""
    return P.encode_from_float(x, cfg)


def ref_planes(pat, ecfg: EulerConfig):
    """Oracle for in-kernel plane construction from patterns."""
    pc = ecfg.posit
    f = P.decode_fields(pat, pc)
    return LM.ilm_planes_from_fields(
        f["sign"], f["scale"], f["frac"], f["is_zero"] | f["is_nar"],
        pc.frac_window, ecfg.stages, ecfg.trunc, ecfg.sublane)


def ref_logmac(a_pat, b_pat, ecfg: EulerConfig):
    """Oracle for the logmac kernel: f32 (M, N) = va·vb - ra·rb (the rem
    dot is always subtracted, as in the reference oracle)."""
    va, ra = ref_planes(a_pat, ecfg)
    vb, rb = ref_planes(b_pat, ecfg)
    return va @ vb - ra @ rb


def ref_exact_posit_mac(a_pat, b_pat, cfg: P.PositConfig):
    """The exact-posit (R4BM baseline) MAC matmul: both operands decoded
    exactly, their products summed in f32.

    Words on a CUDA device are decoded by the decode kernel
    (``ops.decode``), with NaR set back to NaN as the oracle has it; the
    product is ``torch.matmul`` in f32, as the reference computes it with
    ``jnp.dot`` outside any kernel."""
    if torch.as_tensor(a_pat).device.type == "cuda":
        from . import ops as _K
        va, vb = (_decode_nan(_K.decode(p, cfg), p, cfg)
                  for p in (a_pat, b_pat))
    else:
        va, vb = P.decode_to_float(a_pat, cfg), P.decode_to_float(b_pat, cfg)
    return torch.matmul(va, vb)


def _decode_nan(val, pat, cfg: P.PositConfig):
    nar = (pat.to(torch.int64) & P.mask(cfg.n_bits)) == 1 << (cfg.n_bits - 1)
    return torch.where(nar, torch.full_like(val, float("nan")), val)
