"""Quire accumulation semantics and their f32 adaptations on torch tensors.

Counterpart of ``repro.core.quire``.  The hardware accumulates aligned
products into a shared 128-bit quire and rounds once (RNE) at the end; the
kernels accumulate in f32.  Here: (a) the exact big-int quire oracle,
(b) Neumaier's compensated sum for long reductions and (c) a chunked
reduction in the order a K-tiled kernel accumulates.
"""
from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch
import torch.nn.functional as F

from . import posit as P


# --------------------------------------------------------------------------
# Exact oracle (numpy / python ints)
# --------------------------------------------------------------------------

def np_quire_dot(pat_a, pat_b, cfg: P.PositConfig) -> Fraction:
    """Exact sum of exact posit products — the ideal 128-bit quire result."""
    total = Fraction(0)
    for a, b in zip(np.asarray(pat_a).ravel(), np.asarray(pat_b).ravel()):
        va = P.np_decode(int(a), cfg)
        vb = P.np_decode(int(b), cfg)
        if np.isnan(va) or np.isnan(vb):
            continue
        total += Fraction(va) * Fraction(vb)
    return total


def np_quire_round(total: Fraction, cfg: P.PositConfig) -> int:
    """RNE the exact quire value into an output posit pattern."""
    return P.np_encode(float(total), cfg)


# --------------------------------------------------------------------------
# f32 accumulation strategies
# --------------------------------------------------------------------------

def kahan_sum(x, axis: int = -1):
    """Kahan-Neumaier compensated summation along ``axis``.

    One step per element of the reduced axis, vectorised over the other
    axes, with the reference scan's operations in its order.  Neumaier's
    variant also survives the |xi| > |s| cancellation that defeats classic
    Kahan."""
    x = torch.movedim(torch.as_tensor(x), axis, 0)
    s = torch.zeros_like(x[0])
    c = torch.zeros_like(x[0])
    for xi in x:
        t = s + xi
        big = torch.abs(s) >= torch.abs(xi)
        c = c + torch.where(big, (s - t) + xi, (xi - t) + s)
        s = t
    return s + c


def chunked_sum(x, axis: int = -1, chunk: int = 256):
    """Chunked reduction: each chunk of ``chunk`` summed, then the chunk
    sums — the order a K-tiled kernel accumulates in."""
    x = torch.movedim(torch.as_tensor(x), axis, -1)
    pad = (-x.shape[-1]) % chunk
    if pad:
        x = F.pad(x, (0, pad))
    x = x.reshape(x.shape[:-1] + (-1, chunk))
    return x.sum(-1).sum(-1)
