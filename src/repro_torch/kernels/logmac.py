"""Fused logarithmic-posit MAC matmul: the CUDA kernel and its plain version.

``decode_planes_raw`` turns posit patterns into (val, rem) f32 ILM planes
with the kernels' arithmetic: a regime scan of fixed depth ``rcap``, m /
sub-lane truncation, clearing the top ``stages`` set bits, and 2^e built
as two exponent-field factors.  ``logmac`` multiplies ``(M,K)`` by
``(K,N)`` pattern matrices into the f32 ``(M,N)`` "quire" value
``sum va*vb - sum ra*rb``: the plain version for CPU tensors, the
``csrc/logmac.cu`` and ``csrc/logmac_pieces.cu`` kernels for CUDA tensors,
chosen by :func:`_plan` from the shape and the format alone: the split-K
small-M kernel for ``M <= SMALL_M_MAX`` (decode steps and short prefills);
above it the split-K fp16 tensor-core kernel where :func:`mma_key` finds
every plane value exact in fp16 (P8 and P16 L-21b), else the split-K bf16
tensor-core kernel where :func:`pieces_key` splits every plane value into
at most five exact bf16 pieces a word (P32 L-21b and L-22b, the other P16
variants), else the 64x64 f32 tile kernel (the unbounded P32 variants,
P32 without truncation).  Above SMALL_M_MAX the K-split depends on N, K
and the format alone, so a row's result is the same bits whatever rows
share the call; inside :func:`column_block` N is the whole product's, so
a column-parallel rank's columns are the same bits as one process's.

As in the TPU kernel (``repro/kernels/logmac.py:144``), the rem dot is
subtracted only when ``stages > 0`` and the mode is ``euler``.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
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


# The tensor-core kernels' geometry (csrc/mma_sync.cuh: MMA_BN, MMA_BK;
# csrc/logmac.cu: MMA_BPS, MmaShape; csrc/logmac_pieces.cu: PC_TM, PC_BPS,
# PC_MAX_NP, PiecesShape): 128 columns a block, K in stages of 16; the
# fp16 kernel takes 64 or 128 rows a block, the bf16-piece kernel 64.  Two
# blocks fit on an SM (105-109 KB of shared memory each), so the K-split
# aims one row tile's grid at one wave of MMA_TARGET_BLOCKS, from the
# column tiles alone
MMA_BN = 128
MMA_BK = 16
MMA_TARGET_BLOCKS = 2 * N_SMS
MMA_KS_MIN = 128          # K rows per split at least (8 stages)
PIECES_TM = 64            # the bf16-piece kernel's rows a block
PIECES_MAX = 5            # bf16 pieces a word at most (six do not fit
                          # two blocks an SM)
# S * column tiles <= MMA_TARGET_BLOCKS wherever S > 1, so one row tile's
# [S, 128, N] partials take at most a quarter of this (17.3 M floats,
# 69 MB); a launch holds as many row tiles as fit
# (``LogmacPlan.launch_rows``), so that a tall call at a narrow N fills
# the card in few launches
MMA_SCRATCH_MAX_FLOATS = 4 * MMA_TARGET_BLOCKS * 128 * MMA_BN


class LogmacPlan(NamedTuple):
    kind: str      # "small" (split-K, M <= SMALL_M_MAX), "mma", "pieces"
                   # or "tile"
    bn: int        # output columns per block
    splits: int    # K-splits S (a row tile's grid: column tiles x S)
    ks: int        # K rows per split (the last split may be shorter)
    mr: int        # rows per block: the small kernel's bound (>= M), the
                   # tensor-core kernels' block rows (64 or 128)
    cpt: int       # consecutive columns per thread (words per vector load)
    pieces: tuple = (0, 0)   # bf16 pieces of a val and a rem plane value

    def launch_rows(self, M: int, N: int) -> int:
        """Rows a launch of a tensor-core kernel covers: every row without
        K-splits, else as many whole row tiles (at least one) as keep the
        [S, rows, N] partials within MMA_SCRATCH_MAX_FLOATS."""
        if self.splits == 1:
            return M
        tiles = MMA_SCRATCH_MAX_FLOATS // (self.splits * N * self.mr)
        return max(1, tiles) * self.mr

    def blocks(self, N: int) -> int:
        """Blocks of one row tile of the small or a tensor-core kernel."""
        return -(-N // self.bn) * self.splits

    def scratch_floats(self, M: int, N: int) -> int:
        """Floats of the partial sums: [S, 2, M, N] for the small kernel,
        [S, rows, N] of one launch for the tensor-core kernels (0 when
        S == 1)."""
        if self.splits == 1:
            return 0
        if self.kind in ("mma", "pieces"):
            return self.splits * min(M, self.launch_rows(M, N)) * N
        return 2 * self.splits * M * N


def _split_k(N: int, K: int, target: int) -> tuple[int, int]:
    """(S, ks) of a tensor-core plan: K split into as many ranges as keep
    one row tile's grid within ``target`` blocks, each at least MMA_KS_MIN
    rows and a whole number of stages; from N and K alone."""
    want = target // -(-N // MMA_BN)
    if want <= 1 or K < 2 * MMA_KS_MIN:
        return 1, K
    ks = max(MMA_KS_MIN, -(-K // (want * MMA_BK)) * MMA_BK)
    return -(-K // ks), ks


def _plan(M: int, N: int, K: int, mma: bool = False,
          pieces: tuple[int, int] | None = None,
          split_n: int | None = None) -> LogmacPlan:
    """Which logmac kernel runs an (M,K) x (K,N) product, and its grid;
    ``mma``: the format's planes are exact in fp16 (:func:`mma_key`);
    ``pieces``: else its bf16 piece counts (:func:`pieces_key`).

    Small M: the column tiles alone rarely fill the card (18 blocks at
    N=2304), so K is split into as many splits as keep the grid within
    TARGET_BLOCKS, each at least KS_MIN rows.  The head (2000 tiles) runs
    unsplit.  Above SMALL_M_MAX the tensor-core kernels split K the same
    way, from the column tiles alone, for one row tile's grid of at most
    one wave of their blocks (hymba's k, v has 3 column tiles), each split
    at least MMA_KS_MIN rows: every row tile of a taller call runs the same
    split (a launch holds as many row tiles as the scratch bound allows),
    so a row's sum is the same whatever M is.  ``split_n``: the N the
    K-split is chosen for (default N), so that a block of a product's
    columns sums K as the whole product does."""
    split_n = N if split_n is None else split_n
    if M > SMALL_M_MAX and mma:
        S, ks = _split_k(split_n, K, MMA_TARGET_BLOCKS)
        return LogmacPlan("mma", MMA_BN, S, ks, 64 if M <= 64 else 128, 4)
    if M > SMALL_M_MAX and pieces:
        S, ks = _split_k(split_n, K, MMA_TARGET_BLOCKS)
        return LogmacPlan("pieces", MMA_BN, S, ks, PIECES_TM, 4, pieces)
    if M > SMALL_M_MAX:
        return LogmacPlan("tile", 64, 1, K, 64, 4)
    mr = next(r for r in (4, 8, 16, 32) if M <= r)
    cpt = 4 if mr <= 8 else (2 if mr == 16 else 1)
    want = TARGET_BLOCKS // -(-split_n // SMALL_BN)
    if want <= 1 or K < 2 * KS_MIN:
        return LogmacPlan("small", SMALL_BN, 1, K, mr, cpt)
    ks = max(KS_MIN, -(-K // (want * K_ALIGN)) * K_ALIGN)
    return LogmacPlan("small", SMALL_BN, -(-K // ks), ks, mr, cpt)


def plan_of(M: int, N: int, K: int, ecfg: EulerConfig,
            split_n: int | None = None) -> LogmacPlan:
    """The plan :func:`logmac` runs for this shape and format."""
    return _plan(M, N, K, mma_key(ecfg.posit, ecfg),
                 pieces_key(ecfg.posit, ecfg), split_n)


_COLUMNS = threading.local()


@contextlib.contextmanager
def column_block(parts: int):
    """Products run inside compute a block of ``1 / parts`` of their
    columns (a weight split by column over ``parts`` ranks): each plans
    its K-split for ``N * parts`` columns, so that every column sums K in
    the order of the whole product."""
    prev = getattr(_COLUMNS, "parts", 1)
    _COLUMNS.parts = parts
    try:
        yield
    finally:
        _COLUMNS.parts = prev


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


def _bf16_pieces(bits: int) -> int:
    """Round-to-nearest bf16 pieces that sum to any value of ``bits``
    significant bits: one for up to 8 bits, one more for each further 9
    (the remainder of a rounding to 8 bits is at most half its last
    place)."""
    return 0 if bits <= 0 else 1 + max(0, -(-(bits - 8) // 9))


def pieces_key(pc: P.PositConfig, ecfg: EulerConfig) -> tuple[int, int] | None:
    """``(val pieces, rem pieces)`` of a format the bf16-piece kernel
    (csrc/logmac_pieces.cu) takes, else None: the one place that decides.
    It takes a format where every (val, rem) plane value splits exactly
    into round-to-nearest bf16 pieces, each zero or normal, every product
    of two an exact normal f32, in at most PIECES_MAX pieces a word.

    A nonzero val plane has ``min(m + 1, 24)`` significant bits (m kept
    fraction bits; above 24 the f32 plane is a rounding) and its lowest
    bit at ``2^(scale - min(m, 23))`` or above; the rem plane keeps at most
    ``m + 1 - stages`` of the mantissa's bits, the lowest at
    ``2^(scale - m)`` or above (no pieces unless the rem dot is
    subtracted).  The pieces of a value are multiples of its lowest bit,
    so where twice the lowest exponent is at least -126 every piece is
    zero or a normal bf16 and every product of two pieces (at most 16
    significant bits) is an exact normal f32: the kernel's f32 sums take
    the f32 kernels' products exactly.  Taken: P32 L-21b (m 16, scales
    [-20, 19]; 2 val, 1 rem) and L-22b (3, 2), the P16 variants ((2, 1)
    or (2, 2)).  Refused: the unbounded P32 variants (scales down to
    -120: the pieces underflow) and P32 without truncation (L-1b, L-2b:
    3 + 3 pieces)."""
    m = effective_trunc(ecfg.trunc, ecfg.sublane)
    m = pc.frac_window if m is None else min(m, pc.frac_window)
    pv = _bf16_pieces(min(m + 1, 24))
    pr = (_bf16_pieces(min(m + 1 - ecfg.stages, 24))
          if subtracts_rem(ecfg) else 0)
    low_v, low_r = pc.min_scale - min(m, 23), pc.min_scale - m
    if (2 * low_v < -126 or (pr and 2 * low_r < -126)
            or pv + pr > PIECES_MAX):
        return None
    return (pv, pr)


def bf16_pieces(v: torch.Tensor, n: int) -> list[torch.Tensor]:
    """``v`` (f32) as ``n`` bf16 pieces (held as f32), each the
    round-to-nearest-even bf16 of what the earlier ones leave: the
    kernel's split (csrc/logmac_pieces.cu: split_bf16)."""
    out = []
    for _ in range(n):
        h = v.to(torch.bfloat16).to(torch.float32)
        out.append(h)
        v = v - h
    return out


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


def _vec16(a_pat, b_pat) -> bool:
    """16-byte copies need 4-word aligned rows and bases."""
    K, Nc = b_pat.shape
    return (K % 4 == 0 and Nc % 4 == 0 and a_pat.data_ptr() % 16 == 0
            and b_pat.data_ptr() % 16 == 0)


def _row_chunks(a_pat, out, plan: LogmacPlan):
    """(A rows, output rows) of each launch, ``plan.launch_rows`` at a
    time: each row tile runs the same split whatever launch it is in."""
    rows = plan.launch_rows(*out.shape)
    for c0 in range(0, a_pat.shape[0], rows):
        yield a_pat[c0:c0 + rows], out[c0:c0 + rows]


def _launch_mma(a_pat, b_pat, out, plan: LogmacPlan,
                ecfg: EulerConfig) -> None:
    """The fp16 tensor-core kernel, and its split-K reduce when
    ``plan.splits > 1``, on checked CUDA operands, writing ``out``."""
    Mr, K = a_pat.shape
    Nc = b_pat.shape[1]
    tab = (_table16(a_pat.device, table16_key(ecfg.posit, ecfg))
           if ecfg.posit.n_bits == 16 else None)
    fn = _build.function("logmac", "logmac_mma_launch",
                         [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13
                         + [ctypes.c_void_p])
    nscr = plan.scratch_floats(Mr, Nc)
    part = (torch.empty(nscr, dtype=torch.float32, device=a_pat.device)
            if nscr else None)
    for a, o in _row_chunks(a_pat, out, plan):
        _build.check(fn(a.data_ptr(), b_pat.data_ptr(), o.data_ptr(),
                        part.data_ptr() if part is not None else None,
                        tab.data_ptr() if tab is not None else None,
                        a.shape[0], Nc, K, plan.ks, plan.splits, plan.mr,
                        int(_vec16(a_pat, b_pat)), *_format_args(ecfg),
                        _build.stream_ptr(a_pat)), "logmac")


def _launch_pieces(a_pat, b_pat, out, plan: LogmacPlan,
                   ecfg: EulerConfig) -> None:
    """The bf16-piece tensor-core kernel, and its split-K reduce when
    ``plan.splits > 1``, on checked CUDA operands, writing ``out``."""
    Mr, K = a_pat.shape
    Nc = b_pat.shape[1]
    nscr = plan.scratch_floats(Mr, Nc)
    part = (torch.empty(nscr, dtype=torch.float32, device=a_pat.device)
            if nscr else None)
    fn = _build.function("logmac_pieces", "logmac_pieces_launch",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13
                         + [ctypes.c_void_p])
    for a, o in _row_chunks(a_pat, out, plan):
        _build.check(fn(a.data_ptr(), b_pat.data_ptr(), o.data_ptr(),
                        part.data_ptr() if part is not None else None,
                        a.shape[0], Nc, K, plan.ks, plan.splits,
                        *plan.pieces, int(_vec16(a_pat, b_pat)),
                        *_format_args(ecfg)[:5], _build.stream_ptr(a_pat)),
                     "logmac")


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
    plan = plan_of(Mr, Nc, K, ecfg, Nc * getattr(_COLUMNS, "parts", 1))
    if plan.kind == "mma":
        _launch_mma(a_pat, b_pat, out, plan, ecfg)
    elif plan.kind == "pieces":
        _launch_pieces(a_pat, b_pat, out, plan, ecfg)
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
             "pieces": "logmac_pieces", "tile": "logmac_tile"}
