"""EULER-ADAS neural compute engine on torch tensors.

Counterpart of ``repro.core.engine``: ``EulerConfig`` (posit width/es,
regime bound, ILM stages n, truncation m, SIMD mode, framework knobs) and
``euler_dot_general``, the drop-in for ``lax.dot_general`` with JAX's
dimension-number convention.  Modes: ``exact``, ``posit``, ``euler``,
``quant_only`` and ``logfxp`` (the paper's Table VI log-fixed-point
baseline).  ``euler_matmul``, ``euler_einsum_qk`` and ``euler_einsum_pv``
are ``euler_dot_general`` with the reference's dimension numbers.

Gradients are straight-through: the forward sees the approximate value,
``x + (approx - x).detach()``; the rem plane carries no gradient.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any

import torch

from . import logmult as LM
from . import posit as P

# (n_low, n_high, m_low, m_high) per width — Section II-B.3
_KNOBS = {8: (2, 3, 4, 5), 16: (4, 6, 8, 10), 32: (8, 12, 16, 20)}
_RBOUND = {8: 2, 16: 3, 32: 5}

VARIANT_NAMES = ("L-1", "L-2", "L-21", "L-22", "L-1b", "L-2b", "L-21b", "L-22b")


@dataclasses.dataclass(frozen=True)
class EulerConfig:
    """Full operating-point description of the EULER-ADAS NCE."""

    width: int = 16                  # posit word width: 8 | 16 | 32
    bounded: bool = True             # B-Posit regime bound (R per _RBOUND)
    stages: int = 6                  # ILM stage count n
    trunc: int | None = 10           # truncation width m (None = no truncation)
    mode: str = "euler"              # exact|posit|euler|quant_only|logfxp
    simd: str = "scalar"             # scalar | 8_16 | 8_16_32
    out_quant: bool = False          # re-encode accumulator output to posit
    accum: str = "f32"               # f32 (kahan is not ported)
    fuse_planes: bool = False        # one concat-K dot instead of two
    pre_scale: bool = True           # per-tensor power-of-2 scaling
    dtype: Any = torch.float32

    @property
    def posit(self) -> P.PositConfig:
        es = {8: 0, 16: 1, 32: 2}[self.width]
        r = _RBOUND[self.width] if self.bounded else None
        return P.PositConfig(self.width, es, r)

    @property
    def sublane(self) -> int | None:
        """SIMD shared-datapath sub-lane width (models Table I SIMD rows)."""
        if self.simd == "scalar" or self.width == 8:
            return None
        return 8

    @property
    def variant(self) -> str:
        n_lo, n_hi, m_lo, m_hi = _KNOBS[self.width]
        base = {(n_lo, None): "L-1", (n_hi, None): "L-2",
                (n_hi, m_lo): "L-21", (n_hi, m_hi): "L-22"}.get(
                    (self.stages, self.trunc), f"L-n{self.stages}m{self.trunc}")
        return base + ("b" if self.bounded else "")

    @property
    def paper_name(self) -> str:
        s = f"LP-{self.stages}"
        if self.trunc is not None:
            s += f"_T{self.trunc}"
        if self.bounded:
            s = f"b{_RBOUND[self.width]}_" + s
        return s

    def replace(self, **kw) -> "EulerConfig":
        return dataclasses.replace(self, **kw)


def from_variant(width: int, variant: str, **kw) -> EulerConfig:
    """Build an EulerConfig from a paper variant name like ``L-21b``."""
    bounded = variant.endswith("b")
    v = variant[:-1] if bounded else variant
    n_lo, n_hi, m_lo, m_hi = _KNOBS[width]
    table = {"L-1": (n_lo, None), "L-2": (n_hi, None),
             "L-21": (n_hi, m_lo), "L-22": (n_hi, m_hi)}
    if v not in table:
        raise ValueError(f"unknown variant {variant}")
    n, m = table[v]
    return EulerConfig(width=width, bounded=bounded, stages=n, trunc=m, **kw)


EXACT = EulerConfig(mode="exact")


# --------------------------------------------------------------------------
# dot_general with JAX's dimension numbers
# --------------------------------------------------------------------------

_TLS = threading.local()


def in_no_batch_dot() -> bool:
    """Whether the aten op running now is the contraction of a dot with no
    batch dimensions (``dot_general`` runs every dot as ``torch.bmm``, so
    the op's name and shape cannot tell).  The remat policy ``"dots"``
    saves exactly these outputs, as JAX's
    ``dots_with_no_batch_dims_saveable`` does."""
    return getattr(_TLS, "no_batch", False)


@contextlib.contextmanager
def no_batch_dot():
    """Mark the contractions issued inside as dots with no batch dims."""
    prev = in_no_batch_dot()
    _TLS.no_batch = True
    try:
        yield
    finally:
        _TLS.no_batch = prev

def dot_general(a: torch.Tensor, b: torch.Tensor, dimension_numbers,
                out_dtype=torch.float32) -> torch.Tensor:
    """``lax.dot_general`` in torch, accumulated in float32.

    Output layout follows lax: batch dims, then a's free dims, then b's
    free dims.  Operands are upcast to float32 first (bf16 products are
    exact there, which is what ``preferred_element_type=f32`` gives)."""
    (lc, rc), (lb, rb) = dimension_numbers
    lc, rc, lb, rb = tuple(lc), tuple(rc), tuple(lb), tuple(rb)
    a_free = [d for d in range(a.ndim) if d not in lc and d not in lb]
    b_free = [d for d in range(b.ndim) if d not in rc and d not in rb]
    batch_shape = [a.shape[d] for d in lb]
    a_free_shape = [a.shape[d] for d in a_free]
    b_free_shape = [b.shape[d] for d in b_free]
    nb, M, N = (math.prod(batch_shape), math.prod(a_free_shape),
                math.prod(b_free_shape))
    K = math.prod(a.shape[d] for d in lc)
    a2 = a.permute(*lb, *a_free, *lc).reshape(nb, M, K).to(torch.float32)
    b2 = b.permute(*rb, *rc, *b_free).reshape(nb, K, N).to(torch.float32)
    with no_batch_dot() if not lb else contextlib.nullcontext():
        out = torch.bmm(a2, b2)
    return out.reshape(*batch_shape, *a_free_shape, *b_free_shape).to(out_dtype)


# --------------------------------------------------------------------------
# Plane construction with straight-through gradients
# --------------------------------------------------------------------------

def _ste(approx, x):
    """Forward ``approx``, backward identity w.r.t. ``x``."""
    return x + (approx - x).detach()


def _pow2_scale(x, group=None):
    """Per-tensor power-of-2 scale centering the log-magnitude mass at 1
    (the hardware's per-layer exponent bias).

    ``group``: the process group over which ``x``'s rows are split (data
    parallel); the sum of log2 and the count of nonzeros are then summed
    over it before the mean is rounded, so every rank gets the scale of
    the whole tensor, as the reference's GSPMD run computes it.

    Only normal nonzero values count: the reference's ``ax > 0`` runs
    under XLA's flush, which reads a subnormal as 0."""
    ax = x.detach().to(torch.float32).abs()
    nz = ax >= P.MIN_NORMAL
    lg = torch.where(nz, torch.log2(ax), torch.zeros((), device=ax.device))
    lg_sum, count = lg.sum(), nz.sum()
    if group is not None:
        from repro_torch.distributed.collectives import all_reduce
        pair = all_reduce(torch.stack([lg_sum.to(torch.float64),
                                       count.to(torch.float64)]), group)
        lg_sum, count = pair[0].to(torch.float32), pair[1]
    mean_lg = lg_sum / torch.clamp(count, min=1).to(torch.float32)
    s = torch.exp2(torch.round(mean_lg))
    return torch.clamp(s, min=1e-30)


@contextlib.contextmanager
def statistics_groups(group_a, group_b):
    """The process groups over which operands a and b of the dots and
    elementwise products issued inside take their per-tensor statistics
    (None: the operand's own, as on one device).  ``numerics.api`` sets
    them from the context's group or the groups a call names."""
    prev = statistics_group_pair()
    _TLS.groups = (group_a, group_b)
    try:
        yield
    finally:
        _TLS.groups = prev


def statistics_group_pair() -> tuple:
    return getattr(_TLS, "groups", (None, None))


# values per slice of an operand's plane construction: the plain codec's
# int64 temporaries scale with the slice, not with the operand (one
# llama4-scout expert weight is 671 M values)
PLANE_CHUNK = 1 << 24


def _by_leading_rows(fn, x):
    """``fn(x)``, a pair of tensors (or None) shaped like ``x`` and
    elementwise in it, computed over slices of ``x``'s leading dimension
    of at most ``PLANE_CHUNK`` values (a single row may hold more) and
    written into whole outputs.  The slices' values, and under autograd
    their gradients, are those of one call on the whole tensor."""
    if x.ndim == 0 or x.numel() <= PLANE_CHUNK:
        return fn(x)
    n0 = x.shape[0]
    rows = max(1, PLANE_CHUNK // max(x.numel() // n0, 1))
    if rows >= n0:
        return fn(x)
    outs = None
    for r0 in range(0, n0, rows):
        part = fn(x[r0:r0 + rows])
        if outs is None:
            outs = [None if p is None else
                    torch.empty(x.shape, dtype=p.dtype, device=p.device)
                    for p in part]
        for o, p in zip(outs, part):
            if o is not None:
                o[r0:r0 + rows] = p
    return tuple(outs)


_PLANES_MEMO = None


@contextlib.contextmanager
def shapes_only_planes(memo):
    """Inside, the plane construction of an operand on the ``meta`` device
    (shapes only, outside autograd) goes through ``memo(key, fn)``, ``key``
    its shape, dtype and config, ``fn`` the construction: the dry run
    (``launch.dryrun``) runs it once per key and replays its outputs'
    shapes, counts and peak bytes after (the codec's ~500 ops a dot
    dominate a shapes-only step)."""
    global _PLANES_MEMO
    prev, _PLANES_MEMO = _PLANES_MEMO, memo
    try:
        yield
    finally:
        _PLANES_MEMO = prev


def _codec(planes, x, cfg: EulerConfig):
    memo = _PLANES_MEMO
    if (memo is None or x.device.type != "meta"
            or (torch.is_grad_enabled() and x.requires_grad)):
        return _by_leading_rows(planes, x)
    return memo((tuple(x.shape), x.dtype, cfg),
                lambda: _by_leading_rows(planes, x))


def operand_planes(x, cfg: EulerConfig, group=None):
    """(val, rem) planes for one operand under ``cfg`` (STE gradients).

    The per-tensor statistics (the pow2 pre-scale, logfxp's max) come from
    the whole tensor, over ``group`` where its rows are split over one;
    the elementwise codec then runs over slices of the leading dimension
    of at most ``PLANE_CHUNK`` values."""
    if cfg.mode == "exact":
        return x.to(cfg.dtype), None
    if cfg.mode == "logfxp":
        frac_exp = LM.fxp_frac_exp(x.detach().to(torch.float32), cfg.width,
                                   group)

        def planes(xc):
            val, rem = LM.logfxp_planes(xc.to(torch.float32), cfg.width,
                                        cfg.stages, frac_exp)
            return _ste(val, xc).to(cfg.dtype), rem.detach().to(cfg.dtype)

        return _codec(planes, x, cfg)
    pc = cfg.posit
    s = (_pow2_scale(x, group) if cfg.pre_scale
         else torch.ones((), dtype=torch.float32, device=x.device))
    if cfg.mode in ("posit", "quant_only"):
        def planes(xc):
            q = P.flush_subnormals(P.quantize(
                P.flushed_quotient(xc.to(torch.float32), s), pc) * s)
            return _ste(q, xc).to(cfg.dtype), None
    elif cfg.mode == "euler":
        def planes(xc):
            val, rem = LM.ilm_planes_from_float(
                P.flushed_quotient(xc.to(torch.float32), s), pc,
                cfg.stages, cfg.trunc, cfg.sublane)
            return (_ste(val * s, xc).to(cfg.dtype),
                    (rem * s).detach().to(cfg.dtype))
    else:
        raise ValueError(f"unknown mode {cfg.mode}")
    return _codec(planes, x, cfg)


def euler_dot_general(a, b, dimension_numbers, cfg: EulerConfig):
    """Drop-in ``lax.dot_general`` under EULER-ADAS numerics: f32
    accumulation inside the dot, result stored at ``cfg.dtype``."""
    ga, gb = statistics_group_pair()
    va, ra = operand_planes(a, cfg, ga)
    vb, rb = operand_planes(b, cfg, gb)
    (lc, rc), _ = dimension_numbers
    if (ra is not None and rb is not None and cfg.fuse_planes
            and len(lc) == 1):
        va2 = torch.cat([va, ra], dim=lc[0])
        vb2 = torch.cat([vb, -rb], dim=rc[0])
        out = dot_general(va2, vb2, dimension_numbers)
    else:
        out = dot_general(va, vb, dimension_numbers)
        if ra is not None and rb is not None:
            out = out - dot_general(ra, rb, dimension_numbers)
    if cfg.out_quant and cfg.mode != "exact":
        out = _ste(P.quantize(out.to(torch.float32), cfg.posit),
                   out).to(out.dtype)
    return out.to(torch.promote_types(va.dtype, vb.dtype))


def euler_matmul(a, b, cfg: EulerConfig):
    """a @ b (contract a's last dim with b's first) under EULER numerics."""
    dn = (((a.ndim - 1,), (0,)), ((), ()))
    return euler_dot_general(a, b, dn, cfg)


def euler_einsum_qk(q, k, cfg: EulerConfig):
    """Attention scores q·k^T over the last dim: [..., T, D] x [..., S, D]."""
    nd = q.ndim
    batch = tuple(range(nd - 2))
    dn = (((nd - 1,), (nd - 1,)), (batch, batch))
    return euler_dot_general(q, k, dn, cfg)


def euler_einsum_pv(p, v, cfg: EulerConfig):
    """Attention values p·v: [..., T, S] x [..., S, D]."""
    nd = p.ndim
    batch = tuple(range(nd - 2))
    dn = (((nd - 1,), (nd - 2,)), (batch, batch))
    return euler_dot_general(p, v, dn, cfg)


def ilm_elementwise(a, b, cfg: EulerConfig):
    """Elementwise EULER product (the reference's SSD state-update op)."""
    ga, gb = statistics_group_pair()
    va, ra = operand_planes(a, cfg, ga)
    vb, rb = operand_planes(b, cfg, gb)
    out = va * vb
    if ra is not None and rb is not None:
        out = out - ra * rb
    return out
