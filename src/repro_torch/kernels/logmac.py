"""Fused logarithmic-posit MAC matmul: the CUDA kernel and its plain version.

``decode_planes_raw`` turns posit patterns into (val, rem) f32 ILM planes
with the kernels' arithmetic: a regime scan of fixed depth ``rcap``, m /
sub-lane truncation, clearing the top ``stages`` set bits, and 2^e built
as two exponent-field factors.  ``logmac`` multiplies ``(M,K)`` by
``(K,N)`` pattern matrices into the f32 ``(M,N)`` "quire" value
``sum va*vb - sum ra*rb``: the plain version for CPU tensors, the
``csrc/logmac.cu`` kernels for CUDA tensors, chosen by :func:`_plan` from
the shape and the format alone: the split-K small-M kernel for
``M <= SMALL_M_MAX`` (decode steps and short prefills); above it the
split-K tensor-core kernel where :func:`mma_key` finds every plane value
exact in fp16 (P8 and P16 L-21b), else the 64x64 f32 tile kernel (P32).

As in the TPU kernel (``repro/kernels/logmac.py:144``), the rem dot is
subtracted only when ``stages > 0`` and the mode is ``euler``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

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


# The small-M kernel's geometry (csrc/logmac.cu: SM_BN, SmallShape)
SMALL_M_MAX = 32          # crossover: the tile kernel takes M above it
SMALL_BN = 128            # output columns per block
N_SMS = 132               # streaming multiprocessors of an H100 SXM
# Two blocks fit on an SM (the kernel's launch bounds; 64-96 KB of shared
# memory each).  Split-K grids aim at one such wave: blocks that all run at
# once pay their prologue (P16 table, A's planes) together, and no SM waits
# on a last partial wave (scripts/logmac_split_sweep.py times every split
# count; PERF.md has its numbers)
TARGET_BLOCKS = 2 * N_SMS
K_ALIGN = 16              # a K-split's rows are a multiple of this
KS_MIN = 64               # and at least this many
# S * tiles <= TARGET_BLOCKS wherever S > 1, so the [S, 2, M, N] partials
# never exceed this
SCRATCH_MAX_FLOATS = 2 * SMALL_M_MAX * TARGET_BLOCKS * SMALL_BN


# The tensor-core kernel's geometry (csrc/logmac.cu: MMA_BN, MMA_BK,
# MMA_BPS, MmaShape): 128 columns and 64 or 128 rows a block, K in stages
# of 16.  Two blocks fit on an SM (105 KB of shared memory each at 128
# rows), so its split-K grids aim at one wave of MMA_TARGET_BLOCKS
MMA_BN = 128
MMA_BK = 16
MMA_TARGET_BLOCKS = 2 * N_SMS
MMA_KS_MIN = 128          # K rows per split at least (8 stages)
# S * tiles <= MMA_TARGET_BLOCKS wherever S > 1 and a tile holds at most
# 128 x 128 outputs, so the [S, M, N] partials never exceed this
MMA_SCRATCH_MAX_FLOATS = MMA_TARGET_BLOCKS * 128 * MMA_BN


class LogmacPlan(NamedTuple):
    kind: str      # "small" (split-K, M <= SMALL_M_MAX), "mma" or "tile"
    bn: int        # output columns per block
    splits: int    # K-splits S (grid = column tiles x row tiles x S)
    ks: int        # K rows per split (the last split may be shorter)
    mr: int        # rows per block: the small kernel's bound (>= M) or the
                   # mma kernel's block rows (64 or 128)
    cpt: int       # consecutive columns per thread (words per vector load)

    def row_tiles(self, M: int) -> int:
        return -(-M // self.mr) if self.kind == "mma" else 1

    def blocks(self, N: int, M: int = 1) -> int:
        return -(-N // self.bn) * self.row_tiles(M) * self.splits

    def scratch_floats(self, M: int, N: int) -> int:
        """Floats of the partial sums: [S, 2, M, N] for the small kernel,
        [S, M, N] for the mma kernel (0 when S == 1)."""
        if self.splits == 1:
            return 0
        return (1 if self.kind == "mma" else 2) * self.splits * M * N


def _plan(M: int, N: int, K: int, mma: bool = False) -> LogmacPlan:
    """Which logmac kernel runs an (M,K) x (K,N) product, and its grid;
    ``mma``: the format's planes are exact in fp16 (:func:`mma_key`).

    Small M: the column tiles alone rarely fill the card (18 blocks at
    N=2304), so K is split into as many splits as keep the grid within
    TARGET_BLOCKS, each at least KS_MIN rows.  The head (2000 tiles) runs
    unsplit.  Above SMALL_M_MAX the mma kernel splits K the same way into
    a grid of at most MMA_TARGET_BLOCKS blocks (hymba's k, v at M = 256 has
    6 output tiles), each split at least MMA_KS_MIN rows."""
    if M > SMALL_M_MAX and mma:
        bm = 64 if M <= 64 else 128
        tiles = -(-N // MMA_BN) * -(-M // bm)
        want = MMA_TARGET_BLOCKS // tiles
        if want <= 1 or K < 2 * MMA_KS_MIN:
            return LogmacPlan("mma", MMA_BN, 1, K, bm, 4)
        ks = max(MMA_KS_MIN, -(-K // (want * MMA_BK)) * MMA_BK)
        return LogmacPlan("mma", MMA_BN, -(-K // ks), ks, bm, 4)
    if M > SMALL_M_MAX:
        return LogmacPlan("tile", 64, 1, K, 64, 4)
    mr = next(r for r in (4, 8, 16, 32) if M <= r)
    cpt = 4 if mr <= 8 else (2 if mr == 16 else 1)
    want = TARGET_BLOCKS // -(-N // SMALL_BN)
    if want <= 1 or K < 2 * KS_MIN:
        return LogmacPlan("small", SMALL_BN, 1, K, mr, cpt)
    ks = max(KS_MIN, -(-K // (want * K_ALIGN)) * K_ALIGN)
    return LogmacPlan("small", SMALL_BN, -(-K // ks), ks, mr, cpt)


def table16_key(pc: P.PositConfig, ecfg: EulerConfig):
    """``(es, regime bound, stages, truncation)`` of a 16-bit format whose
    words the kernels decode through a 4096-entry table, else None.

    A nonzero word's planes depend on its sign and on the body bits that
    its regime (at most the bound), exponent and kept fraction read; where
    those add up to at most 12 (P16 L-21b: 3 + 1 + 8), they are the top 12
    of the 15 body bits, so the table of the bodies ``(i << 3) | 1`` holds
    every word's planes up to the sign (csrc/logmac_decode.cuh:
    FMT_TABLE16).  The one place that decides which formats take it."""
    m = effective_trunc(ecfg.trunc, ecfg.sublane)
    R = pc.regime_max or 0
    if pc.n_bits != 16 or R == 0 or m is None or R + pc.es + m > 12:
        return None
    return (pc.es, R, ecfg.stages, m)


def mma_key(pc: P.PositConfig, ecfg: EulerConfig) -> bool:
    """Whether every (val, rem) plane value of the format is exact in fp16,
    so the tensor-core kernel (csrc/logmac.cu: logmac_mma_kernel) computes
    the same products as the f32 kernels: the one place that decides.

    A nonzero val plane is ``±2^(scale - m) * j`` with ``j < 2^(m + 1)``
    (m kept fraction bits) and ``scale`` in [min_scale, max_scale]; the rem
    plane keeps a subset of the same bits.  Both are exact in fp16 when the
    significand fits its 11 bits (m <= 10), the leading bit its largest
    exponent (max_scale <= 15) and the lowest bit its subnormal step
    (min_scale - m >= -24).  P8 L-21b: m 4, scales [-2, 1]; P16 L-21b: m 8,
    scales [-6, 5]; P32 L-21b (m 16) is refused.  The kernel decodes 8-bit
    words through a 256-entry table and 16-bit words through
    :func:`table16_key`'s, so a 16-bit format needs that table too."""
    if pc.n_bits not in (8, 16) or (pc.n_bits == 16
                                    and table16_key(pc, ecfg) is None):
        return False
    m = effective_trunc(ecfg.trunc, ecfg.sublane)
    m = pc.frac_window if m is None else min(m, pc.frac_window)
    return m <= 10 and pc.max_scale <= 15 and pc.min_scale - m >= -24


_TABLES16: dict[tuple, torch.Tensor] = {}


def _table16(device: torch.device, key: tuple) -> torch.Tensor:
    """The (val, rem) table of :func:`table16_key`'s format ``key`` on
    ``device``, built once by the kernels' own decoder (csrc/logmac.cu:
    logmac_table16): ``[4096 * 2]`` f32, the planes of the bodies
    ``(i << 3) | 1``."""
    tab = _TABLES16.get((device, key))
    if tab is None:
        tab = torch.empty(4096 * 2, dtype=torch.float32, device=device)
        fn = _build.function("logmac", "logmac_table16",
                             [ctypes.c_void_p] + [ctypes.c_int] * 5
                             + [ctypes.c_void_p])
        _build.check(fn(tab.data_ptr(), 16, *key, _build.stream_ptr(tab)),
                     "logmac_table16")
        torch.cuda.synchronize(device)   # ready for launches on any stream
        _TABLES16[(device, key)] = tab
    return tab


def _format_args(ecfg: EulerConfig) -> tuple:
    """The kernels' format arguments: n_bits, es, regime bound, stages,
    truncation (-1 = none), whether the rem dot is subtracted."""
    pc = ecfg.posit
    m = effective_trunc(ecfg.trunc, ecfg.sublane)
    return (pc.n_bits, pc.es, pc.regime_max or 0, ecfg.stages,
            -1 if m is None else m, int(subtracts_rem(ecfg)))


def _launch_mma(a_pat, b_pat, out, plan: LogmacPlan,
                ecfg: EulerConfig) -> None:
    """The tensor-core kernel, and its split-K reduce when
    ``plan.splits > 1``, on checked CUDA operands, writing ``out``."""
    Mr, K = a_pat.shape
    Nc = b_pat.shape[1]
    nscr = plan.scratch_floats(Mr, Nc)
    part = (torch.empty(nscr, dtype=torch.float32, device=a_pat.device)
            if nscr else None)
    # 16-byte copies need 4-word aligned rows and bases
    vec = (K % 4 == 0 and Nc % 4 == 0 and a_pat.data_ptr() % 16 == 0
           and b_pat.data_ptr() % 16 == 0)
    tab = (_table16(a_pat.device, table16_key(ecfg.posit, ecfg))
           if ecfg.posit.n_bits == 16 else None)
    fn = _build.function("logmac", "logmac_mma_launch",
                         [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13
                         + [ctypes.c_void_p])
    _build.check(fn(a_pat.data_ptr(), b_pat.data_ptr(), out.data_ptr(),
                    part.data_ptr() if part is not None else None,
                    tab.data_ptr() if tab is not None else None, Mr, Nc, K,
                    plan.ks, plan.splits, plan.mr, int(vec),
                    *_format_args(ecfg), _build.stream_ptr(a_pat)), "logmac")


def _launch_small(a_pat, b_pat, out, plan: LogmacPlan,
                  ecfg: EulerConfig) -> None:
    """The small-M kernel, and its split-K reduce when ``plan.splits > 1``,
    on checked CUDA operands, writing ``out``."""
    Mr, K = a_pat.shape
    Nc = b_pat.shape[1]
    nscr = plan.scratch_floats(Mr, Nc)
    part = (torch.empty(nscr, dtype=torch.float32, device=a_pat.device)
            if nscr else None)
    # vector loads need CPT-word aligned rows and base
    vec = Nc % plan.cpt == 0 and b_pat.data_ptr() % (4 * plan.cpt) == 0
    key = table16_key(ecfg.posit, ecfg)
    tab = _table16(a_pat.device, key) if key is not None else None
    fn = _build.function("logmac", "logmac_small_launch",
                         [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13
                         + [ctypes.c_void_p])
    _build.check(fn(a_pat.data_ptr(), b_pat.data_ptr(), out.data_ptr(),
                    part.data_ptr() if part is not None else None,
                    tab.data_ptr() if tab is not None else None, Mr, Nc, K,
                    plan.ks, plan.splits, plan.mr, int(vec),
                    *_format_args(ecfg), _build.stream_ptr(a_pat)), "logmac")


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
    out = torch.empty((Mr, Nc), dtype=torch.float32, device=a_pat.device)
    plan = _plan(Mr, Nc, K, mma_key(ecfg.posit, ecfg))
    if plan.kind == "mma":
        _launch_mma(a_pat, b_pat, out, plan, ecfg)
    elif plan.kind == "tile":
        fn = _build.function("logmac", "logmac_launch",
                             [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                             + [ctypes.c_void_p])
        _build.check(fn(a_pat.data_ptr(), b_pat.data_ptr(), out.data_ptr(),
                        Mr, Nc, K, *_format_args(ecfg),
                        _build.stream_ptr(a_pat)), "logmac")
    else:
        _launch_small(a_pat, b_pat, out, plan, ecfg)
    _build.count_launch("logmac", ecfg.posit.n_bits)
    _build.count_launch(KERNEL_OF[plan.kind], ecfg.posit.n_bits)
    return out


# The launch counter of each kind's kernel (``_build.LAUNCHES``; "logmac"
# counts every launch of the wrapper)
KERNEL_OF = {"small": "logmac_small", "mma": "logmac_mma",
             "tile": "logmac_tile"}
