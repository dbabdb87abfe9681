"""How the port's kernels split their work, checked on the CPU.

* logmac: the plan (`kernels/logmac.py:_plan`) that picks the small-M
  split-K kernel or the tile kernel and sizes the grid.
* paged flash-decode: the page-parallel schedule of
  `csrc/paged_decode.cu` (page maxima, prefix-max encode, telescoped
  weights), built here from the plain pieces and held against the serial
  plain version `_flash_plain`.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import posit as TP
from repro_torch.core.engine import VARIANT_NAMES, from_variant
from repro_torch.kernels import logmac as TLM
from repro_torch.kernels import paged_decode as TPD
from repro_torch.kernels.logmac import decode_planes_raw, subtracts_rem
from repro_torch.kernels.posit_codec import encode_body

torch.set_num_threads(1)

GEMMA_KN = [(2304, 2304), (2304, 1152), (2304, 9216), (9216, 2304),
            (2304, 256000)]
SMALL_MS = [1, 4, 5, 8, 16, 17, 31, 32]
EDGE_KN = [(2301, 1155), (0, 64), (1, 1), (64, 3), (127, 5), (128, 5),
           (130, 7), (4096, 130), (100000, 16)]
CSRC = Path(TLM.__file__).resolve().parent / "csrc"


@pytest.mark.parametrize("M", SMALL_MS + [33, 128])
@pytest.mark.parametrize("kn", GEMMA_KN + EDGE_KN, ids=str)
def test_logmac_plan_splits_tile_k(M, kn):
    """The K-splits cover K exactly once: every split but the last is ks
    rows, the last is 1..ks rows."""
    K, N = kn
    plan = TLM._plan(M, N, K)
    assert plan.splits >= 1
    if plan.splits == 1:
        assert plan.ks == K
    else:
        assert plan.ks % TLM.K_ALIGN == 0 and plan.ks >= TLM.KS_MIN
        assert plan.ks * (plan.splits - 1) < K <= plan.ks * plan.splits


@pytest.mark.parametrize("M", SMALL_MS)
@pytest.mark.parametrize("kn", GEMMA_KN, ids=str)
def test_logmac_plan_fills_the_card(M, kn):
    """Every gemma2-2b projection gets one wave of two blocks per SM on 132
    SMs: at least 80 % of TARGET_BLOCKS and, where K is split, no more than
    that; the head is wide enough to run unsplit."""
    K, N = kn
    plan = TLM._plan(M, N, K)
    assert plan.kind == "small"
    assert TLM.TARGET_BLOCKS == 2 * TLM.N_SMS
    assert plan.blocks(N) >= 0.8 * TLM.TARGET_BLOCKS
    if plan.splits > 1:
        assert plan.blocks(N) <= TLM.TARGET_BLOCKS
    if -(-N // TLM.SMALL_BN) >= TLM.TARGET_BLOCKS:
        assert plan.splits == 1


@pytest.mark.parametrize("M", list(range(1, 40)) + [64, 128, 512])
def test_logmac_plan_crossover(M):
    """M <= SMALL_M_MAX takes the small kernel built for the least of 4, 8,
    16, 32 rows that holds M, with at most 64 accumulators a thread,
    whatever the format; above it, the tensor-core kernel where the
    format's planes are exact in fp16 (64-row blocks up to M = 64), else
    the tile kernel."""
    plan = TLM._plan(M, 9216, 2304)
    if M > TLM.SMALL_M_MAX:
        assert plan.kind == "tile" and plan.splits == 1
        mma = TLM._plan(M, 9216, 2304, mma=True)
        assert mma.kind == "mma" and mma.bn == TLM.MMA_BN
        assert mma.mr == (64 if M <= 64 else 128)
        return
    assert TLM._plan(M, 9216, 2304, mma=True) == plan
    assert plan.kind == "small" and plan.bn == TLM.SMALL_BN
    assert plan.mr == min(r for r in (4, 8, 16, 32) if r >= M)
    assert 2 * plan.mr * plan.cpt <= 64
    assert (TLM.SMALL_BN // plan.cpt) % 32 == 0    # whole warps along N


@pytest.mark.parametrize("M", SMALL_MS)
def test_logmac_plan_scratch_within_its_bound(M):
    """The [S, 2, M, N] partials stay within SCRATCH_MAX_FLOATS (8.6 MB):
    a split grid holds at most TARGET_BLOCKS tiles of SMALL_BN columns."""
    rng = np.random.default_rng(M)
    shapes = GEMMA_KN + EDGE_KN + [
        (int(k), int(n)) for k, n in zip(rng.integers(1, 20000, 40),
                                         rng.integers(1, 300000, 40))]
    for K, N in shapes:
        plan = TLM._plan(M, N, K)
        got = plan.scratch_floats(M, N)
        assert got == (2 * plan.splits * M * N if plan.splits > 1 else 0)
        assert got <= TLM.SCRATCH_MAX_FLOATS
        if plan.splits > 1:
            assert plan.blocks(N) <= TLM.TARGET_BLOCKS


def test_logmac_plan_matches_kernel_source():
    """The plan's geometry is the kernel's: columns per block, threads, and
    the columns a thread owns at each row bound; for the tensor-core
    kernels their columns and K rows per block (the shared header), the
    blocks an SM holds (the plan's wave) and the row tilings the launches
    accept."""
    src = "".join((CSRC / f).read_text() for f in (
        "logmac.cu", "mma_sync.cuh", "logmac_pieces.cu"))
    assert re.search(rf"constexpr int SM_BN = {TLM.SMALL_BN};", src)
    assert re.search(r"constexpr int SM_THREADS = 256;", src)
    assert "CPT = MR <= 8 ? 4 : (MR == 16 ? 2 : 1)" in src
    assert re.search(rf"constexpr int MMA_BN = {TLM.MMA_BN};", src)
    assert re.search(rf"constexpr int MMA_BK = {TLM.MMA_BK};", src)
    bps = int(re.search(r"constexpr int MMA_BPS = (\d+);", src).group(1))
    assert TLM.MMA_TARGET_BLOCKS == bps * TLM.N_SMS
    assert "__launch_bounds__(MMA_THREADS, MMA_BPS)" in src
    assert "if (bm == 64)" in src and "if (bm == 128)" in src
    assert TLM.MMA_KS_MIN % TLM.MMA_BK == 0
    assert re.search(rf"constexpr int PC_MAX_NP = {TLM.PIECES_MAX};", src)
    assert re.search(rf"constexpr int PC_TM = {TLM.PIECES_TM};", src)
    assert "constexpr int PC_BPS = 2;" in src
    assert "__launch_bounds__(MMA_THREADS, PC_BPS)" in src
    assert TLM._plan(33, 9216, 2304, pieces=(2, 1)).mr == TLM.PIECES_TM
    for M in (4, 8, 16, 32):
        plan = TLM._plan(M, 9216, 2304)
        assert plan.cpt == (4 if M <= 8 else 2 if M == 16 else 1)


# The tensor-core kernels' splits before this plan took them from the
# column tiles alone (M <= 128 has one row tile, so these held for every
# M in (32, 128]): (S, ks) at gemma2-2b's and hymba-1.5b's shapes (K, N)
PARENT_MMA_SPLITS = {
    (2304, 2304): (14, 176), (2304, 1152): (18, 128), (2304, 9216): (3, 768),
    (9216, 2304): (14, 672), (2304, 256000): (1, 2304),
    (1600, 6482): (5, 320), (3200, 1600): (20, 160), (1600, 1600): (13, 128),
    (1600, 320): (13, 128), (1600, 5504): (6, 272), (5504, 1600): (20, 288),
    (1600, 32016): (1, 1600)}
ROW_COUNTS = [33, 64, 65, 128, 129, 200, 256, 512, 1000, 4096]
TC_KINDS = [dict(mma=True), dict(pieces=(2, 1)), dict(pieces=(2, 2)),
            dict(pieces=(3, 2))]


@pytest.mark.parametrize("kw", TC_KINDS, ids=str)
@pytest.mark.parametrize("kn", list(PARENT_MMA_SPLITS) + EDGE_KN, ids=str)
def test_tensor_core_split_ignores_the_row_count(kn, kw):
    """Above 32 rows a tensor-core plan's (S, ks) is the same at every row
    count for the same (N, K, format), so a row's sum is too."""
    K, N = kn
    want = TLM._plan(33, N, K, **kw)
    assert want.kind in ("mma", "pieces")
    for M in ROW_COUNTS:
        plan = TLM._plan(M, N, K, **kw)
        assert (plan.kind, plan.splits, plan.ks, plan.pieces) == (
            want.kind, want.splits, want.ks, want.pieces), M


@pytest.mark.parametrize("parts", [2, 16])
@pytest.mark.parametrize("kw", TC_KINDS + [{}], ids=str)
@pytest.mark.parametrize("M", [4, 32, 64, 512])
def test_column_block_runs_the_whole_products_split(M, kw, parts):
    """A block of N / parts columns planned for N (``column_block``, a
    column-parallel rank's projection) runs the whole [K, N] product's
    kernel and K-split, so each of its columns sums K in that order."""
    for K, N in GEMMA_KN + list(PARENT_MMA_SPLITS):
        if N % parts:
            continue
        whole = TLM._plan(M, N, K, **kw)
        block = TLM._plan(M, N // parts, K, split_n=N, **kw)
        assert (block.kind, block.splits, block.ks) == (
            whole.kind, whole.splits, whole.ks), (K, N)


def test_column_parts_reach_the_logmac_plan(monkeypatch):
    """``numerics.dot_general(column_parts=m)`` runs its product inside
    ``logmac.column_block(m)``, and only then."""
    from repro_torch import numerics as N
    seen, block = [], TLM.column_block

    def spy(parts):
        seen.append(parts)
        return block(parts)
    monkeypatch.setattr(TLM, "column_block", spy)
    a, b = torch.ones(2, 8), torch.ones(8, 4)
    dn = (((1,), (0,)), ((), ()))
    ctx = N.NumericsContext.from_ecfg(from_variant(16, "L-21b"), "cuda")
    want = N.dot_general(a, b, dn, ctx)
    got = N.dot_general(a, b, dn, ctx, column_parts=2)
    assert seen == [2] and torch.equal(got, want)


@pytest.mark.parametrize("M", [33, 64, 65, 100, 128])
def test_mma_plan_up_to_128_rows_is_the_parents(M):
    """At 32 < M <= 128 the fp16 kernel's plan is the one it had before the
    split was made row-count free: the same split, the same row tiles, one
    launch."""
    for (K, N), split in PARENT_MMA_SPLITS.items():
        plan = TLM._plan(M, N, K, mma=True)
        assert (plan.splits, plan.ks) == split
        assert plan.mr == (64 if M <= 64 else 128)
        assert plan.launch_rows(M, N) >= M


@pytest.mark.parametrize("kw", TC_KINDS, ids=str)
def test_tensor_core_scratch_within_its_bound(kw):
    """Each launch's [S, rows, N] partials stay within
    MMA_SCRATCH_MAX_FLOATS at every row count, and the launches cover the
    rows once in whole row tiles."""
    rng = np.random.default_rng(7)
    shapes = list(PARENT_MMA_SPLITS) + EDGE_KN + [
        (int(k), int(n)) for k, n in zip(rng.integers(1, 20000, 30),
                                         rng.integers(1, 300000, 30))]
    for K, N in shapes:
        for M in ROW_COUNTS:
            plan = TLM._plan(M, N, K, **kw)
            rows = plan.launch_rows(M, N)
            assert rows == M if plan.splits == 1 else rows % plan.mr == 0
            assert plan.scratch_floats(M, N) <= TLM.MMA_SCRATCH_MAX_FLOATS
            if plan.splits > 1:
                assert plan.blocks(N) <= TLM.MMA_TARGET_BLOCKS


# --------------------------------------------------------------------------
# the 16-bit decode table (csrc/logmac_decode.cuh: FMT_TABLE16)
# --------------------------------------------------------------------------

def _bodies16() -> torch.Tensor:
    """The 4096 positive bodies ``(i << 3) | 1`` the table is built from."""
    return (torch.arange(4096, dtype=torch.int64) << 3) | 1


def _table_lookup(pat, tv, tr):
    """The kernels' FMT_TABLE16 decode of 16-bit patterns from a table's
    planes: the entry of the top 12 body bits, its sign flipped for a
    negative word, 0 for zero and NaR."""
    p = pat & 0xFFFF
    neg = (p >> 15) == 1
    body = torch.where(neg, (-p) & 0x7FFF, p & 0x7FFF)
    zero = torch.zeros(())
    v = torch.where(neg, -tv[body >> 3], tv[body >> 3])
    r = torch.where(neg, -tr[body >> 3], tr[body >> 3])
    return (torch.where(body == 0, zero, v), torch.where(body == 0, zero, r))


TABLE16_FORMATS = [(es, R, stages, trunc)
                   for es in (0, 1, 2) for R in (1, 2, 3, 4, 5)
                   for stages in (0, 6) for trunc in (None, 6, 8, 9, 10)]


@pytest.mark.parametrize("fmt", TABLE16_FORMATS, ids=str)
def test_table16_formats_decode_through_the_table(fmt):
    """Every 16-bit pattern of a format that ``table16_key`` admits decodes
    through the table bit for bit as ``decode_planes_raw`` decodes it; a
    format one body bit over the table's 12 (regime bound + es + kept
    fraction = 13) does not, so the predicate is tight."""
    es, R, stages, trunc = fmt
    pc = TP.PositConfig(16, es, R)
    ecfg = from_variant(16, "L-21b").replace(stages=stages, trunc=trunc)
    key = TLM.table16_key(pc, ecfg)
    admitted = trunc is not None and R + es + trunc <= 12
    assert (key is not None) == admitted
    if not admitted and (trunc is None or R + es + trunc != 13):
        return
    pats = torch.arange(1 << 16, dtype=torch.int64)
    want = decode_planes_raw(pats, pc, stages, trunc, None)
    got = _table_lookup(pats, *decode_planes_raw(_bodies16(), pc, stages,
                                                 trunc, None))
    same = all(bool((g.view(torch.int32) == w.view(torch.int32)).all())
               for g, w in zip(got, want))
    assert same == admitted
    if admitted:
        assert key == (es, R, stages, trunc)


def test_table16_key_of_the_served_formats():
    """P16 L-21b (the served format) takes the table; P8 and P32, an
    unbounded P16 and P16 without truncation do not."""
    served = from_variant(16, "L-21b")
    assert TLM.table16_key(served.posit, served) == (1, 3, 6, 8)
    for cfg in (from_variant(8, "L-21b"), from_variant(32, "L-21b"),
                from_variant(16, "L-21"), from_variant(16, "L-2b")):
        assert TLM.table16_key(cfg.posit, cfg) is None


# --------------------------------------------------------------------------
# paged flash-decode: the page-parallel schedule against the serial walk
# --------------------------------------------------------------------------

def _visit(p: int, window, ps: int, nlp: int) -> range:
    """The pages the kernel visits for a row at position p (csrc/
    paged_decode.cu: visit_range)."""
    w = -1 if window is None else int(window)
    first = p - w + 1 if w >= 0 else 0
    plo = first // ps if first > 0 else 0
    phi = min(p // ps, nlp - 1)
    if p >= 0 and plo <= phi:
        return range(plo, phi + 1)
    return range(nlp)


def _page_parallel(qpat, k_pages, v_pages, table, pos, window, scl, *, pc,
                   cfg_qk, cfg_pv, softcap, ppb=1):
    """The kernel's schedule with the plain pieces (batched over rows as
    ``_flash_plain`` is, so both encode the same f32 probabilities): pass 1
    scores every page and takes its max; pass 2 encodes exp(s - m_j)
    against the prefix max m_j of the page maxima and weights the page's
    PV and sum by exp(m_j - m_last), adding them in page order within each
    chunk of ``ppb`` pages; the combine adds the chunks in order."""
    B, KV, G, hd = qpat.shape
    ps, nlp = k_pages.shape[1], table.shape[1]
    w = TPD._window_int(window)
    qv, qr = decode_planes_raw(qpat, cfg_qk.posit, cfg_qk.stages,
                               cfg_qk.trunc, cfg_qk.sublane)
    pos_b = pos.to(torch.int64).reshape(B, 1, 1, 1)
    neg = torch.tensor(-1e30)
    scores = []
    for j in range(nlp):                                 # pass 1
        kw = k_pages[table[:, j].long()].permute(0, 2, 1, 3)
        kv_, kr = decode_planes_raw(kw, pc, cfg_qk.stages, cfg_qk.trunc,
                                    cfg_qk.sublane)
        s = TPD.page_scores(qv, qr, kv_, kr, scl, subtracts_rem(cfg_qk),
                            softcap)
        spos = torch.arange(ps) + j * ps
        ok = spos <= pos_b
        if w >= 0:
            ok = ok & (spos > pos_b - w)
        scores.append(torch.where(ok, s, neg))
    pmax = [s.amax(-1, keepdim=True) for s in scores]
    visits = torch.zeros((B, nlp), dtype=torch.bool)
    for b in range(B):
        visits[b, list(_visit(int(pos[b]), window, ps, nlp))] = True
    vis = visits.reshape(B, 1, 1, nlp)
    m_last = torch.full((B, KV, G, 1), -1e30)
    for j in range(nlp):
        m_last = torch.where(vis[..., j:j + 1],
                             torch.maximum(m_last, pmax[j]), m_last)
    m_j = torch.full((B, KV, G, 1), -1e30)
    acc = torch.zeros((B, KV, G, hd))
    l_sum = torch.zeros((B, KV, G, 1))
    chunk_acc, chunk_l = torch.zeros_like(acc), torch.zeros_like(l_sum)
    for j in range(nlp):                                 # pass 2, combine
        m_j = torch.where(vis[..., j:j + 1], torch.maximum(m_j, pmax[j]), m_j)
        pexp = torch.exp(scores[j] - m_j)
        pv_, pr = decode_planes_raw(encode_body(pexp, cfg_pv.posit),
                                    cfg_pv.posit, cfg_pv.stages,
                                    cfg_pv.trunc, cfg_pv.sublane)
        vw = v_pages[table[:, j].long()].permute(0, 2, 1, 3)
        vv, vr = decode_planes_raw(vw, pc, cfg_pv.stages, cfg_pv.trunc,
                                   cfg_pv.sublane)
        o = pv_ @ vv
        if subtracts_rem(cfg_pv):
            o = o - pr @ vr
        weight = torch.where(vis[..., j:j + 1], torch.exp(m_j - m_last),
                             torch.zeros(()))
        chunk_acc = chunk_acc + o * weight
        chunk_l = chunk_l + pexp.sum(-1, keepdim=True) * weight
        if (j + 1) % ppb == 0 or j == nlp - 1:
            acc, l_sum = acc + chunk_acc, l_sum + chunk_l
            chunk_acc, chunk_l = torch.zeros_like(acc), torch.zeros_like(l_sum)
    out = acc / torch.clamp(l_sum, min=1e-30)
    return out.reshape(B, 1, KV * G * hd)


@pytest.mark.parametrize("ppb", [1, 4])
@pytest.mark.parametrize("window", [None, 4096, 24])
@pytest.mark.parametrize("fmt", ["bposit16", "posit8"])
def test_page_parallel_schedule_matches_serial_walk(window, fmt, ppb):
    """Row 0 sits past several pages (the window skips leading ones at 24),
    row 1 is on its first page, row 2 fills the table, row 3 has no valid
    position, so every page is visited and every weight is 1."""
    g = torch.Generator().manual_seed(5)
    B, KV, G, hd, ps, nlp = 4, 2, 2, 16, 8, 6
    pc = TP.BPOSIT16 if fmt == "bposit16" else TP.POSIT8
    ecfg = from_variant(16, "L-21b")
    n_pages = TPD.RESERVED_PAGES + B * nlp
    kf = torch.randn((n_pages, ps, KV, hd), generator=g)
    vf = torch.randn((n_pages, ps, KV, hd), generator=g)
    kf[:TPD.RESERVED_PAGES] = 0
    vf[:TPD.RESERVED_PAGES] = 0
    kp = TP.to_storage(TP.encode_from_float(kf, pc), pc)
    vp = TP.to_storage(TP.encode_from_float(vf, pc), pc)
    pos = torch.tensor([37, 3, 47, -1], dtype=torch.int32)
    table = torch.zeros((B, nlp), dtype=torch.int32)
    nxt = TPD.RESERVED_PAGES
    for r in range(B):
        for j in range(nlp if r == 3 else int(pos[r]) // ps + 1):
            table[r, j] = nxt
            nxt += 1
    q = torch.randn((B, 1, KV * G, hd), generator=g) * 3
    qs, scl = TPD._q_setup(q, kp, ecfg)
    qpat = encode_body(qs, ecfg.posit)
    kw = dict(pc=pc, cfg_qk=ecfg, cfg_pv=ecfg, softcap=50.0)
    want = TPD._flash_plain(qpat, kp, vp, table, pos, window, scl, **kw)
    got = _page_parallel(qpat, kp, vp, table, pos, window, scl, ppb=ppb,
                         **kw)
    assert got.shape == want.shape == (B, 1, KV * G * hd)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    if window == 24:
        assert _visit(37, 24, ps, nlp) == range(1, 5)   # page 0 skipped
    assert _visit(-1, window, ps, nlp) == range(nlp)


@pytest.mark.parametrize("nlp", [1, 16, 63, 64, 128, 256, 1000])
def test_paged_decode_chunks_cover_the_table(nlp):
    """Each block walks pages_per_block pages; the chunks tile the page
    table, one block per page up to 64-page tables."""
    ppb = TPD.pages_per_block(nlp)
    chunks = [range(c * ppb, min(nlp, c * ppb + ppb))
              for c in range(-(-nlp // ppb))]
    assert [j for c in chunks for j in c] == list(range(nlp))
    assert ppb == 1 if nlp < 128 else len(chunks) <= 2 * 64


def _within_logmac_bound(got, a, b, tc) -> bool:
    """|kernel - plain| <= 1e-5*(|va||vb| + |ra||rb|) + 1e-4 per element
    (chip_smoke.py's logmac bound: it covers reordering the K sum)."""
    va, ra = TLM.decode_planes(a, tc)
    vb, rb = TLM.decode_planes(b, tc)
    bound = 1e-5 * (va.abs() @ vb.abs() + ra.abs() @ rb.abs()) + 1e-4
    return bool(((got - TLM.logmac_plain(a, b, tc)).abs() <= bound).all())


def _within_ulps(got, a, b, tc, units: int = 4) -> bool:
    """|kernel - plain| <= units * 2^-24 * (|va||vb| + |ra||rb|) per
    element, no absolute term: at K = 1 each output is a sum of a few
    exact products on one side and two rounded ones on the other, so
    both lie a few roundings from the exact value."""
    va, ra = TLM.decode_planes(a, tc)
    vb, rb = TLM.decode_planes(b, tc)
    bound = units * 2.0 ** -24 * (va.abs() @ vb.abs() + ra.abs() @ rb.abs())
    return bool(((got - TLM.logmac_plain(a, b, tc)).abs() <= bound).all())


def check_redesigned_kernels_on_card(dev: torch.device) -> None:
    """The redesigned kernels against their plain versions on a CUDA card:
    the served format's decode table bit for bit, logmac over every word
    pattern, the small-M logmac at every row bound and across the
    crossover, the fp16 tensor-core logmac (M > 32 at P8 and P16) at both
    row tilings, the bf16-piece logmac (M > 32, every format routed to it)
    and the tile kernel it left (unbounded P32), with ragged, split and
    misaligned operands, rows whose results do not depend on the row
    count, and the page-parallel paged decode with page chunks, each
    giving the same bits on two launches, then the fused pre-scale +
    encode kernel (``check_encode_prescaled_on_card``).  Shared by the card
    test below (torch alone) and ``tests/test_torch_kernels.py``'s card
    test."""
    from repro_torch.kernels import posit_codec as TPC
    g = torch.Generator(device=dev).manual_seed(0)
    # the served format's decode table, bit for bit the plain decode of
    # its bodies, and logmac over every 8- and 16-bit pattern (and random
    # 32-bit words) with one product per output, so equal to the plain
    # version exactly, but for the bf16-piece kernel (P32 at M = 64): it
    # adds five exact piece products where the plain version rounds two,
    # so it is held to four roundings of the products' magnitudes
    served = from_variant(16, "L-21b")
    tab = TLM._table16(dev, TLM.table16_key(served.posit, served))
    tv, tr = TLM.decode_planes(_bodies16().to(torch.int32).to(dev), served)
    assert bool((tab.view(4096, 2)[:, 0].view(torch.int32)
                 == tv.view(torch.int32)).all())
    assert bool((tab.view(4096, 2)[:, 1].view(torch.int32)
                 == tr.view(torch.int32)).all())
    for width in (8, 16, 32):
        tc = from_variant(width, "L-21b")
        b = (torch.arange(1 << width, dtype=torch.int32, device=dev)
             if width < 32 else torch.randint(
                 -(1 << 31), (1 << 31) - 1, (1 << 20,), generator=g,
                 dtype=torch.int32, device=dev))[None, :]
        for M in (1, 4, 64):
            a = TPC.posit_encode(torch.randn(M, 1, generator=g, device=dev),
                                 tc.posit)
            if TLM.plan_of(M, b.shape[1], 1, tc).kind == "pieces":
                assert _within_ulps(TLM.logmac(a, b, tc), a, b, tc)
            else:
                assert bool((TLM.logmac(a, b, tc)
                             == TLM.logmac_plain(a, b, tc)).all())
    for width in (8, 16, 32):
        tc = from_variant(width, "L-21b")
        for M in (1, 4, 5, 8, 16, 17, 32, 33, 64, 65, 128):
            for K, N in ((300, 70), (1000, 256), (2301, 1155)):
                a = TPC.posit_encode(
                    torch.randn(M, K, generator=g, device=dev), tc.posit)
                b = TPC.posit_encode(
                    torch.randn(K, N, generator=g, device=dev), tc.posit)
                got = TLM.logmac(a, b, tc)
                if K == 300:
                    torch.testing.assert_close(
                        got, TLM.logmac_plain(a, b, tc), rtol=1e-5,
                        atol=1e-4)
                else:
                    # the sum over K runs in another order than the plain
                    # version's: chip_smoke's per-element bound
                    assert _within_logmac_bound(got, a, b, tc)
                assert bool((got == TLM.logmac(a, b, tc)).all())
        flat = TPC.posit_encode(torch.randn(1000 * 256 + 1, generator=g,
                                            device=dev), tc.posit)
        b = flat[1:].view(1000, 256)
        assert b.data_ptr() % 16
        for M in (16, 128):
            a = TPC.posit_encode(torch.randn(M, 1000, generator=g,
                                             device=dev), tc.posit)
            assert _within_logmac_bound(TLM.logmac(a, b, tc), a, b, tc)
    # every format the bf16-piece kernel takes, and the P32 formats the
    # tile kernel keeps (unbounded, or without truncation: six pieces a
    # word), above the crossover
    for width, variant in ([(16, v) for v in VARIANT_NAMES
                            if v != "L-21b"]
                           + [(32, v) for v in VARIANT_NAMES]):
        tc = from_variant(width, variant)
        assert TLM.plan_of(128, 9216, 2304, tc).kind == (
            "pieces" if width == 16 or variant in ("L-21b", "L-22b")
            else "tile")
        for M in (33, 128, 256):
            for K, N in ((300, 70), (2301, 1155)):
                a = TPC.posit_encode(
                    torch.randn(M, K, generator=g, device=dev), tc.posit)
                b = TPC.posit_encode(
                    torch.randn(K, N, generator=g, device=dev), tc.posit)
                got = TLM.logmac(a, b, tc)
                if K == 300:
                    torch.testing.assert_close(
                        got, TLM.logmac_plain(a, b, tc), rtol=1e-5,
                        atol=1e-4)
                else:
                    assert _within_logmac_bound(got, a, b, tc)
                assert bool((got == TLM.logmac(a, b, tc)).all())
    check_row_invariance_on_card(dev, g)
    ecfg = from_variant(16, "L-21b")
    B, KV, G, hd, ps = 3, 2, 2, 32, 8
    for nlp, pos in ((4, [19, -1, 30]), (130, [1000, 3, 1039])):
        n_pages = TPD.RESERVED_PAGES + B * nlp
        table = torch.zeros((B, nlp), dtype=torch.int32)
        nxt = TPD.RESERVED_PAGES
        for r in range(B):
            for j in range(max(pos[r], 0) // ps + 1):
                table[r, j] = nxt
                nxt += 1
        for pc in (TP.BPOSIT16, TP.POSIT8):
            kp, vp = (TP.to_storage(TP.encode_from_float(torch.randn(
                (n_pages, ps, KV, hd), generator=g, device=dev), pc), pc)
                for _ in range(2))
            # q off unit scale, so its pre-scale (the kernel's first
            # launch) matters; and once without pre-scale
            q = torch.randn((B, 1, KV * G, hd), generator=g, device=dev) * 40
            args = (q, kp, vp, table.to(dev),
                    torch.tensor(pos, dtype=torch.int32, device=dev))
            for window, qk in ((None, ecfg), (4096, ecfg), (6, ecfg),
                               (None, ecfg.replace(pre_scale=False))):
                kw = dict(pc=pc, cfg_qk=qk, cfg_pv=ecfg, softcap=50.0)
                got = TPD.paged_flash_decode(*args, window, **kw)
                want = TPD.paged_flash_decode_plain(*args, window, **kw)
                assert float((got - want).abs().max()) <= 1e-3
                assert bool((got == TPD.paged_flash_decode(*args, window,
                                                           **kw)).all())
    check_encode_prescaled_on_card(dev)


def check_row_invariance_on_card(dev: torch.device, g) -> None:
    """Above 32 rows a row's logmac result does not depend on the rows
    beside it: the first 33 rows of calls at M in {33, 128, 129, 256, 512}
    are bit-equal, for the fp16 kernel at P16 and P8 L-21b and the
    bf16-piece kernel at P32 L-21b, on [2304, 9216] and [2304, 2304]."""
    from repro_torch.kernels import posit_codec as TPC
    for width, kind in ((16, "mma"), (8, "mma"), (32, "pieces")):
        tc = from_variant(width, "L-21b")
        for K, N in ((2304, 9216), (2304, 2304)):
            b = TPC.posit_encode(torch.randn(K, N, generator=g, device=dev),
                                 tc.posit)
            a = TPC.posit_encode(torch.randn(512, K, generator=g, device=dev),
                                 tc.posit)
            first = None
            for M in (33, 128, 129, 256, 512):
                assert TLM.plan_of(M, N, K, tc).kind == kind
                rows = TLM.logmac(a[:M], b, tc)[:33].view(torch.int32)
                if first is None:
                    first = rows
                assert torch.equal(rows, first), (width, K, N, M)


def check_encode_prescaled_on_card(dev: torch.device) -> None:
    """The fused pre-scale + encode kernel against its plain version on a
    CUDA card: the scale bit for bit torch's ``_pow2_scale``, the words bit
    for bit, on ragged sizes from one value to grids of several blocks, a
    misaligned base, zeros, NaN, Inf, subnormals, P8/P16/P32 with and
    without pre-scale, the same bits on two launches; and the cuda
    backend's contraction, which must not reach ``_pow2_scale`` on the
    card."""
    from repro_torch.core import engine as TE
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as TOps
    from repro_torch.kernels import posit_codec as TPC
    from repro_torch.numerics import NumericsContext, dot_general
    g = torch.Generator(device=dev).manual_seed(1)

    def spread(n, scale_pow=9):
        x = torch.randn(n, generator=g, device=dev)
        return x * torch.exp2(torch.randint(-scale_pow, scale_pow, (n,),
                                            generator=g, device=dev).float())

    edges = torch.tensor([0.0, -0.0, float("nan"), 1e-40, -1e-40,
                          2.0 ** -126, 3e38, -3e38, 1e-30], device=dev)
    flat = spread(70001)
    xs = [spread(n) for n in (1, 3, 5, 4097, 8192, 8193, 300001)]
    xs += [torch.cat([spread(1000) * 1024, edges]), flat[1:],
           torch.zeros(9, device=dev),
           torch.tensor([1.0, float("inf"), -2.0, float("nan")], device=dev)]
    assert xs[-3].data_ptr() % 16 != 0
    # the compiled formats, and one read at run time (es 2 at 16 bits)
    for pc in (TP.POSIT8, TP.BPOSIT8, TP.BPOSIT16, TP.POSIT32,
               TP.PositConfig(16, 2, None)):
        for pre in (True, False):
            for x in xs:
                w, s = TPC.posit_encode_prescaled(x, pc, pre)
                w2, s2 = TPC.posit_encode_prescaled(x, pc, pre)
                pw, ps = TPC.encode_prescaled_plain(x, pc, pre)
                assert float(s) == float(ps) == float(s2), (x.numel(), pc)
                assert bool((w == pw).all()) and bool((w == w2).all())
    # the cuda route: two fused launches, no _pow2_scale, and the product
    # the parent route (torch's scale, a divide, the plain encode) gives
    tc = from_variant(16, "L-21b")
    a = spread(4 * 2304, 3).view(4, 2304)
    b = spread(2304 * 256).view(2304, 256)
    dn = (((1,), (0,)), ((), ()))
    sa, sb = TE._pow2_scale(a), TE._pow2_scale(b)
    want = TOps.logmac_matmul(TPC.encode_plain(a / sa, tc.posit),
                              TPC.encode_plain(b / sb, tc.posit),
                              tc) * (sa * sb)
    orig = TE._pow2_scale

    def refuse(x):
        raise AssertionError("the cuda route reached _pow2_scale on the card")

    before = _build.LAUNCHES["posit_encode_prescaled"]
    TE._pow2_scale = refuse
    try:
        got = dot_general(a, b, dn, NumericsContext.from_ecfg(tc, "cuda"),
                          op="matmul")
    finally:
        TE._pow2_scale = orig
    assert _build.LAUNCHES["posit_encode_prescaled"] == before + 2
    assert bool((got.view(torch.int32) == want.view(torch.int32)).all())


@pytest.mark.cuda
def test_redesigned_kernels_match_plain_versions_on_card():
    """On a CUDA card; this file imports no JAX, so it runs on a machine
    with torch alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    check_redesigned_kernels_on_card(torch.device("cuda"))


def test_page_scores_follow_the_kernels_summation_order():
    """``paged_decode.lane_dot`` sums as ``pd_scores_kernel`` does: lane
    ``l`` chains ``fmaf`` over ``d = l, l + 32, ...`` from 0, then lane 0
    adds the lanes by the xor butterfly.  Held bit for bit against that
    order written out with numpy (float64 product and sum, one rounding
    to float32 per step) at hd = 72 (lanes with two and three terms),
    and within 1e-5 of the float64 product."""
    import numpy as np
    g = torch.Generator().manual_seed(11)
    a = torch.randn((2, 3, 72), generator=g)
    b = torch.randn((2, 5, 72), generator=g) * 8
    got = TPD.lane_dot(a, b)
    an, bn = a.numpy(), b.numpy()
    want = np.empty(got.shape, dtype=np.float32)
    for i in range(2):
        for gi in range(3):
            for s in range(5):
                lanes = np.zeros(32, dtype=np.float32)
                for d in range(72):
                    lanes[d % 32] = np.float32(
                        np.float64(an[i, gi, d]) * np.float64(bn[i, s, d])
                        + np.float64(lanes[d % 32]))
                h = 16
                while h:
                    lanes[:h] = lanes[:h] + lanes[h:2 * h]
                    h //= 2
                want[i, gi, s] = lanes[0]
    assert np.array_equal(got.numpy(), want)
    exact = torch.einsum("igd,isd->igs", a.double(), b.double())
    assert float((got.double() - exact).abs().max()) <= \
        1e-5 * float(exact.abs().max())
