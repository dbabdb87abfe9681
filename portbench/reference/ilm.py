"""ILM contractions of the reference, in plain torch.

An operand's pre-scale is ``2^round(mean log2 |x|)`` over its normal
nonzero elements, taken over the elements of one call: the whole operand,
or each index of its leading dimension (``per="lead"``), where the
reference computes many of the program's calls in one.  Planes are built a
slice of the leading dimension at a time so that the codec's int64
temporaries stay small.
"""
from __future__ import annotations

import torch

from . import posit as P

CHUNK = 1 << 24


def pow2_scale(x, per: str = "all"):
    """The pre-scale: a 0-dim tensor (``per="all"``) or one per index of
    the leading dim, shaped to broadcast against ``x``."""
    ax = x.detach().to(torch.float32).abs()
    nz = ax >= P.MIN_NORMAL
    lg = torch.where(nz, torch.log2(ax), torch.zeros((), device=ax.device))
    if per == "all":
        lg_sum, count = lg.sum(), nz.sum()
    else:
        lg_sum = lg.reshape(x.shape[0], -1).sum(1)
        count = nz.reshape(x.shape[0], -1).sum(1)
    mean = lg_sum / torch.clamp(count, min=1).to(torch.float32)
    s = torch.clamp(torch.exp2(torch.round(mean)), min=1e-30)
    if per != "all":
        s = s.reshape((x.shape[0],) + (1,) * (x.ndim - 1))
    return s


def planes(x, f: P.Format, per: str = "all", ste: bool = False):
    """(val * s, rem * s) of an operand, float32.  ``ste``: the value plane
    as the reference engine writes it, ``x + (val * s - x)``, which rounds
    where the quantization moves a value far."""
    s = pow2_scale(x, per)
    xf = x.to(torch.float32)
    val = torch.empty_like(xf)
    rem = torch.empty_like(xf)
    n0 = xf.shape[0] if xf.ndim else 1
    rows = max(1, CHUNK // max(xf.numel() // max(n0, 1), 1))
    flat_s = s if per == "all" else None
    for r0 in range(0, n0, rows):
        sl = slice(r0, r0 + rows)
        part = xf[sl]
        sp = flat_s if flat_s is not None else s[sl]
        v, r = P.planes(P.flush(part) / sp, f)
        v = v * sp
        if ste:
            v = part + (v - part)
        val[sl] = v
        rem[sl] = r * sp
    return val, rem


def bmm(a, b):
    """(val_a @ val_b) - (rem_a @ rem_b) on batched planes [n, M, K] x
    [n, K, N]."""
    return torch.bmm(a[0], b[0]) - torch.bmm(a[1], b[1])


def mm(a, b):
    return torch.mm(a[0], b[0]) - torch.mm(a[1], b[1])
