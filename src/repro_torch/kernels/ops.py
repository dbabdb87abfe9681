"""Public wrappers for the kernels.

``euler_matmul_fused(x, w, ecfg)`` is the end-to-end fused path: f32
inputs are posit-encoded (encode kernel) and multiplied through the logmac
kernel into the f32 quire value — the EULER-ADAS NCE in three launches.
``euler_matmul_prescaled(x, w, ecfg)`` is the same product under the
per-tensor pow2 pre-scale: each operand's scale and words come from one
fused pass (``encode_prescaled``), the words go to logmac as they are, and
the product is scaled back by ``sa * sb`` on the device.
``store``, ``load`` and ``quantize`` are the core codec's entries
(``core.posit``'s bits, not the encode and decode kernels': see
``posit_codec``).  Each wrapper dispatches on its tensors' device: CPU
tensors run the plain versions, CUDA tensors the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.core.engine import EulerConfig
from . import logmac as _logmac
from . import posit_codec as _codec


def encode(x: torch.Tensor, pc) -> torch.Tensor:
    return _codec.posit_encode(x, pc)


def encode_prescaled(x: torch.Tensor, pc, pre_scale: bool = True,
                     group=None):
    """f32 -> (posit words of x / s, s), s = the pow2 scale of x (of the
    whole tensor its rows belong to, over ``group``)."""
    return _codec.posit_encode_prescaled(x, pc, pre_scale, group)


def decode(pat: torch.Tensor, pc) -> torch.Tensor:
    """Posit words -> f32 through the decode kernel (0 and NaR -> 0.0)."""
    return _codec.posit_decode(pat, pc)


def store(x: torch.Tensor, pc) -> torch.Tensor:
    """f32 or bf16 -> ``pc``'s storage words, the core codec's encode
    (subnormals -> 0, as XLA flushes them)."""
    return _codec.posit_store(x, pc)


def load(words: torch.Tensor, pc, out_dtype=torch.float32) -> torch.Tensor:
    """Storage words -> f32 or bf16, the core codec's decode (NaR -> NaN)."""
    return _codec.posit_load(words, pc, out_dtype)


def quantize(x: torch.Tensor, pc) -> torch.Tensor:
    """f32 -> ``quantize(x)``, the core codec's round trip in one pass."""
    return _codec.posit_quantize(x, pc)


def logmac_matmul(a_pat: torch.Tensor, b_pat: torch.Tensor,
                  ecfg: EulerConfig) -> torch.Tensor:
    return _logmac.logmac(a_pat, b_pat, ecfg)


def euler_matmul_fused(x: torch.Tensor, w: torch.Tensor,
                       ecfg: EulerConfig) -> torch.Tensor:
    """f32 (M,K) @ (K,N) through the kernelized EULER-ADAS pipeline."""
    pc = ecfg.posit
    a_pat = encode(x.to(torch.float32).contiguous(), pc)
    b_pat = encode(w.to(torch.float32).contiguous(), pc)
    return logmac_matmul(a_pat, b_pat, ecfg)


def euler_matmul_prescaled(x: torch.Tensor, w: torch.Tensor,
                           ecfg: EulerConfig, groups=(None, None)
                           ) -> torch.Tensor:
    """``euler_matmul_fused`` of x / sx and w / sw, scaled back by sx * sw:
    the pre-scaled contraction of the cuda backend.  ``groups``: the
    process groups x's and w's scales are taken over (None: their own)."""
    pc = ecfg.posit
    a_pat, sa = encode_prescaled(x.to(torch.float32).contiguous(), pc,
                                 group=groups[0])
    b_pat, sb = encode_prescaled(w.to(torch.float32).contiguous(), pc,
                                 group=groups[1])
    return logmac_matmul(a_pat, b_pat, ecfg) * (sa * sb)
