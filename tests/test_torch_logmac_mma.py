"""logmac's tensor-core kernel (M > 32, planes exact in fp16), checked on
the CPU: the format predicate ``mma_key``, the plan's third kind, and the
kernel's arithmetic emulated with torch (csrc/logmac.cu:
logmac_mma_kernel).  The card runs the kernel itself in
``test_torch_kernel_plans.py``'s ``check_redesigned_kernels_on_card`` and
in chip_smoke phase 2.

* ``mma_key`` promises that every (val, rem) plane value of an admitted
  format survives a round trip through fp16 unchanged: checked over every
  16-bit pattern of the 150 formats of
  ``test_table16_formats_decode_through_the_table`` and every 8-bit pattern
  of 72 8-bit formats.
* The kernel decodes a word into one fp16 pair (val, rem) from a table,
  the 16-bit formats by the top 12 body bits with the sign flipped, and
  multiplies ``[va | ra]`` by ``[vb ; -rb]`` into one f32 accumulator:
  emulated here, equal to the plain version at K = 1 bit for bit, within
  chip_smoke's per-element bound at larger K.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import posit as TP
from repro_torch.core.engine import from_variant
from repro_torch.kernels import logmac as TLM
from repro_torch.kernels.logmac import decode_planes, decode_planes_raw

torch.set_num_threads(1)

TABLE16_FORMATS = [(es, R, stages, trunc)
                   for es in (0, 1, 2) for R in (1, 2, 3, 4, 5)
                   for stages in (0, 6) for trunc in (None, 6, 8, 9, 10)]
FORMATS8 = [(es, R, stages, trunc)
            for es in (0, 1, 2) for R in (None, 2, 3, 4)
            for stages in (0, 3) for trunc in (None, 4, 5)]


def _fp16_exact(t: torch.Tensor) -> bool:
    back = t.to(torch.float16).to(torch.float32)
    return bool((back.view(torch.int32) == t.view(torch.int32)).all())


def _check_promise(n_bits, fmt):
    es, R, stages, trunc = fmt
    pc = TP.PositConfig(n_bits, es, R)
    ecfg = from_variant(n_bits, "L-21b").replace(stages=stages, trunc=trunc)
    if not TLM.mma_key(pc, ecfg):
        return False
    pats = torch.arange(1 << n_bits, dtype=torch.int64)
    v, r = decode_planes_raw(pats, pc, stages, trunc, None)
    assert _fp16_exact(v) and _fp16_exact(r), fmt
    return True


@pytest.mark.parametrize("fmt", TABLE16_FORMATS, ids=str)
def test_mma_key_promise_16bit(fmt):
    """Every 16-bit pattern of an admitted format has fp16-exact planes; a
    16-bit format is admitted only with the 4096-entry decode table."""
    es, R, stages, trunc = fmt
    pc = TP.PositConfig(16, es, R)
    ecfg = from_variant(16, "L-21b").replace(stages=stages, trunc=trunc)
    if _check_promise(16, fmt):
        assert TLM.table16_key(pc, ecfg) is not None


@pytest.mark.parametrize("fmt", FORMATS8, ids=str)
def test_mma_key_promise_8bit(fmt):
    _check_promise(8, fmt)


def test_mma_key_of_the_served_formats():
    """P8 and P16 L-21b take the tensor cores, P32 L-21b (17 significant
    bits) does not, nor an unbounded P16 (scales up to 28) or P16 without
    truncation."""
    for width in (8, 16):
        cfg = from_variant(width, "L-21b")
        assert TLM.mma_key(cfg.posit, cfg)
    for cfg in (from_variant(32, "L-21b"), from_variant(16, "L-21"),
                from_variant(16, "L-2b")):
        assert not TLM.mma_key(cfg.posit, cfg)
    p32 = from_variant(32, "L-21b")
    v, _ = decode_planes(torch.tensor([0x40000001, 0x7FFFFFF0]), p32)
    assert not _fp16_exact(v)


@pytest.mark.parametrize("M", [1, 32, 33, 64, 65, 128, 200, 256])
def test_logmac_route_follows_the_format(M):
    """The kernel is chosen by M and the format alone: the small-M kernel up
    to 32 rows; above it the fp16 tensor-core kernel at P8/P16 L-21b, the
    bf16-piece kernel at P32 L-21b and P16 L-1b (planes fp16 cannot hold),
    the tile kernel at the unbounded P32 L-21 (both keys refuse it)."""
    for cfg, want in ((from_variant(8, "L-21b"), "mma"),
                      (from_variant(16, "L-21b"), "mma"),
                      (from_variant(32, "L-21b"), "pieces"),
                      (from_variant(16, "L-1b"), "pieces"),
                      (from_variant(32, "L-21"), "tile")):
        kind = TLM.plan_of(M, 2304, 9216, cfg).kind
        assert kind == ("small" if M <= TLM.SMALL_M_MAX else want)
        assert TLM.KERNEL_OF[kind] == f"logmac_{kind}"


HYMBA_KN = [(1600, 6482), (3200, 1600), (1600, 1600), (1600, 320),
            (1600, 5504), (5504, 1600), (1600, 32016)]
GEMMA_KN = [(2304, 2304), (2304, 1152), (2304, 9216), (9216, 2304),
            (2304, 256000)]
EDGE_KN = [(2301, 1155), (0, 64), (1, 1), (64, 3), (127, 5), (256, 5),
           (300, 70), (4096, 130), (100000, 16)]


@pytest.mark.parametrize("M", [33, 64, 65, 128, 200, 256, 1000])
def test_mma_plan_fills_the_card(M):
    """One row tile's grid (64-row blocks up to M = 64) holds at most
    MMA_TARGET_BLOCKS blocks where K is split, at least half of it unless
    K is too short for splits of MMA_KS_MIN rows; splits of whole stages
    cover K once and do not depend on M; a launch covers whole row tiles,
    its [S, rows, N] partials within MMA_SCRATCH_MAX_FLOATS."""
    rng = np.random.default_rng(M)
    shapes = HYMBA_KN + GEMMA_KN + EDGE_KN + [
        (int(k), int(n)) for k, n in zip(rng.integers(1, 20000, 40),
                                         rng.integers(1, 300000, 40))]
    for K, N in shapes:
        plan = TLM._plan(M, N, K, mma=True)
        assert plan.kind == "mma" and plan.mr == (64 if M <= 64 else 128)
        assert plan[2:4] == TLM._plan(128, N, K, mma=True)[2:4]
        tiles = -(-N // TLM.MMA_BN)
        blocks = plan.blocks(N)
        assert blocks == tiles * plan.splits
        assert blocks >= min(TLM.MMA_TARGET_BLOCKS // 2,
                             tiles * max(1, K // TLM.MMA_KS_MIN))
        rows = plan.launch_rows(M, N)
        assert rows >= min(M, plan.mr) and rows % plan.mr == 0 or rows == M
        if plan.splits == 1:
            assert plan.ks == K and plan.scratch_floats(M, N) == 0
            assert rows == M
        else:
            assert blocks <= TLM.MMA_TARGET_BLOCKS
            assert plan.ks % TLM.MMA_BK == 0 and plan.ks >= TLM.MMA_KS_MIN
            assert plan.ks * (plan.splits - 1) < K <= plan.ks * plan.splits
            assert plan.scratch_floats(M, N) == (plan.splits * min(M, rows)
                                                 * N)
            assert plan.scratch_floats(M, N) <= TLM.MMA_SCRATCH_MAX_FLOATS


def _half_pair_table(cfg):
    """The kernel's shared-memory table as (val, rem) fp16 pairs: the 256
    patterns of an 8-bit format, or the 4096 positive 16-bit bodies
    ``(i << 3) | 1``."""
    idx = (torch.arange(256, dtype=torch.int64) if cfg.posit.n_bits == 8
           else (torch.arange(4096, dtype=torch.int64) << 3) | 1)
    v, r = decode_planes(idx, cfg)
    return v.to(torch.float16), r.to(torch.float16)


def _half_planes(pat, cfg):
    """csrc/logmac.cu: half_planes, on int64 patterns."""
    tv, tr = _half_pair_table(cfg)
    if cfg.posit.n_bits == 8:
        i = pat & 0xFF
        return tv[i], tr[i]
    p = pat & 0xFFFF
    neg = (p >> 15) == 1
    body = torch.where(neg, (-p) & 0x7FFF, p & 0x7FFF)
    v = torch.where(neg, -tv[body >> 3], tv[body >> 3])
    r = torch.where(neg, -tr[body >> 3], tr[body >> 3])
    zero = torch.zeros((), dtype=torch.float16)
    return (torch.where(body == 0, zero, v), torch.where(body == 0, zero, r))


@pytest.mark.parametrize("width", [8, 16])
def test_half_table_decode_is_the_plain_decode(width):
    """Every pattern's fp16 pair from the table (sign flipped for a negative
    16-bit word, zero for 0 and NaR) is the plain decode's planes."""
    cfg = from_variant(width, "L-21b")
    pats = torch.arange(1 << width, dtype=torch.int64)
    hv, hr = _half_planes(pats, cfg)
    v, r = decode_planes(pats, cfg)
    for h, want in ((hv, v), (hr, r)):
        got = h.to(torch.float32)
        assert bool((got.view(torch.int32) == want.view(torch.int32)).all())


def _mma_emulated(a_pat, b_pat, cfg):
    """The kernel's product: one f32 accumulation of [va | ra] @ [vb ; -rb]
    over the fp16 planes (products exact in f32)."""
    va, ra = _half_planes(a_pat.to(torch.int64), cfg)
    vb, rb = _half_planes(b_pat.to(torch.int64), cfg)
    a = torch.cat([va, ra], 1).to(torch.float32)
    b = torch.cat([vb, -rb], 0).to(torch.float32)
    return a @ b


@pytest.mark.parametrize("width", [8, 16])
def test_shared_accumulator_exact_at_k1(width):
    """K = 1: va*vb + ra*(-rb) rounded once equals the plain version's
    va*vb - ra*rb over every pattern as B (the difference of two products of
    fp16-exact planes fits a float32 exactly)."""
    cfg = from_variant(width, "L-21b")
    rng = np.random.default_rng(width)
    b = torch.arange(1 << width, dtype=torch.int64)[None, :]
    a = torch.from_numpy(rng.integers(0, 1 << width, (40, 1)))
    got = _mma_emulated(a, b, cfg)
    assert bool((got == TLM.logmac_plain(a, b, cfg)).all())


@pytest.mark.parametrize("width", [8, 16])
@pytest.mark.parametrize("K", [16, 300, 2301])
def test_shared_accumulator_within_the_bound(width, K):
    """At larger K the one accumulator sums both planes' products in
    another order than the plain version: within chip_smoke's per-element
    bound 1e-5 (|va||vb| + |ra||rb|) + 1e-4."""
    cfg = from_variant(width, "L-21b")
    rng = np.random.default_rng(K)
    a = torch.from_numpy(rng.integers(0, 1 << width, (33, K)))
    b = torch.from_numpy(rng.integers(0, 1 << width, (K, 70)))
    got = _mma_emulated(a, b, cfg)
    va, ra = decode_planes(a, cfg)
    vb, rb = decode_planes(b, cfg)
    bound = 1e-5 * (va.abs() @ vb.abs() + ra.abs() @ rb.abs()) + 1e-4
    assert bool(((got - TLM.logmac_plain(a, b, cfg)).abs() <= bound).all())
