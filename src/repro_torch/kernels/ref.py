"""Oracles for every kernel of the port (counterparts of
``repro.kernels.ref``), built on the core codec and ILM planes."""
from __future__ import annotations

from repro_torch.core import logmult as LM
from repro_torch.core import posit as P
from repro_torch.core.engine import EulerConfig


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

