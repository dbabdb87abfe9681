"""logmac's bf16-piece tensor-core kernel (M > 32, the formats fp16 cannot
hold), checked on the CPU: the format predicate ``pieces_key``, the split
``bf16_pieces``, and the kernel's arithmetic emulated with torch
(csrc/logmac_pieces.cu: logmac_pieces_kernel).  The card runs the kernel
itself in ``test_torch_kernel_plans.py``'s
``check_redesigned_kernels_on_card`` and in chip_smoke phase 2.

* ``pieces_key`` promises that every (val, rem) plane value of an
  admitted format is the exact sum of its ``bf16_pieces``, each zero or a
  normal bf16, and that every product of two pieces is at least 2^-126:
  checked over every 16-bit pattern of the eight P16 variants and of the
  150 formats of ``test_torch_logmac_mma.py``, every 8-bit pattern of its
  72 formats, and 2^20 seeded P32 words plus edge words of the eight P32
  variants, against a split computed independently in float64.
* The kernel adds, per k16 step, each A rem piece against every negated
  B rem piece and each A val piece against every B val piece, smallest
  first, into a step sum that it adds to the running f32 sum: emulated
  here within chip_smoke's per-element bound.  The P32 planes the pieces split equal JAX's
  ``repro.kernels.logmac.decode_planes_raw`` bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import posit as TP
from repro_torch.core.engine import VARIANT_NAMES, from_variant
from repro_torch.kernels import logmac as TLM
from repro_torch.kernels.logmac import decode_planes, decode_planes_raw

torch.set_num_threads(1)

TABLE16_FORMATS = [(es, R, stages, trunc)
                   for es in (0, 1, 2) for R in (1, 2, 3, 4, 5)
                   for stages in (0, 6) for trunc in (None, 6, 8, 9, 10)]
FORMATS8 = [(es, R, stages, trunc)
            for es in (0, 1, 2) for R in (None, 2, 3, 4)
            for stages in (0, 3) for trunc in (None, 4, 5)]
NORMAL = 2.0 ** -126


def _pieces64(v: torch.Tensor, n: int) -> list[torch.Tensor]:
    """``v`` split in float64 into ``n`` values of 8 significant bits, each
    the round-to-nearest-even of what the earlier ones leave (frexp and
    ``torch.round``, so neither bf16 conversion nor the host's flush of
    tiny f32 values takes part)."""
    r = v.to(torch.float64)
    out = []
    for _ in range(n):
        m, e = torch.frexp(r)
        p = torch.ldexp(torch.round(m * 256.0), e - 8)
        out.append(p)
        r = r - p
    return out


def _check_promise(v: torch.Tensor, n: int) -> None:
    """The kernel's split of ``v`` into ``n`` pieces: equal to the float64
    split, each bf16-exact and zero or normal, summing back to ``v`` bit
    for bit, every product of two nonzero pieces at least 2^-126."""
    got = TLM.bf16_pieces(v, n)
    want = _pieces64(v, n)
    total = torch.zeros_like(v, dtype=torch.float64)
    for g, w in zip(got, want):
        assert torch.equal(g.to(torch.float64), w)
        back = g.to(torch.bfloat16).to(torch.float32)
        assert torch.equal(back.view(torch.int32), g.view(torch.int32))
        assert bool(((w == 0) | (w.abs() >= NORMAL)).all())
        total = total + w
    # the same value (a -0.0 plane's pieces sum to +0.0), the same bits
    # where nonzero
    assert torch.equal(total, v.to(torch.float64))
    nonzero = v != 0
    assert torch.equal(total.to(torch.float32)[nonzero].view(torch.int32),
                       v[nonzero].view(torch.int32))
    nz = torch.cat([w[w != 0] for w in want]).abs()
    if nz.numel():
        assert float(nz.min()) ** 2 >= NORMAL


def _holds(pats, pc, ecfg, counts=None) -> bool:
    """The promise over ``pats`` for the key's piece counts (or
    ``counts``, where the key refuses a format only for its piece count);
    False where there are none."""
    counts = counts or TLM.pieces_key(pc, ecfg)
    if counts is None:
        return False
    pv, pr = counts
    v, r = decode_planes_raw(pats, pc, ecfg.stages, ecfg.trunc,
                             ecfg.sublane)
    _check_promise(v, pv)
    if pr:
        _check_promise(r, pr)
    else:
        assert not TLM.subtracts_rem(ecfg) or bool((r == 0).all())
    return True


@pytest.mark.parametrize("variant", VARIANT_NAMES)
def test_pieces_key_promise_p16_variants(variant):
    """Every 16-bit pattern of each P16 variant: all eight admitted."""
    cfg = from_variant(16, variant)
    assert _holds(torch.arange(1 << 16, dtype=torch.int64), cfg.posit, cfg)


@pytest.mark.parametrize("fmt", TABLE16_FORMATS, ids=str)
def test_pieces_key_promise_16bit(fmt):
    """Every 16-bit pattern of an admitted format of the 150 (bounded
    regimes, so all admitted)."""
    es, R, stages, trunc = fmt
    pc = TP.PositConfig(16, es, R)
    ecfg = from_variant(16, "L-21b").replace(stages=stages, trunc=trunc)
    assert _holds(torch.arange(1 << 16, dtype=torch.int64), pc, ecfg)


def test_pieces_key_promise_8bit():
    """Every 8-bit pattern of the 72 8-bit formats: all admitted."""
    pats = torch.arange(1 << 8, dtype=torch.int64)
    for es, R, stages, trunc in FORMATS8:
        pc = TP.PositConfig(8, es, R)
        ecfg = from_variant(8, "L-21b").replace(stages=stages, trunc=trunc)
        assert _holds(pats, pc, ecfg), (es, R, stages, trunc)


def _p32_words(pc: TP.PositConfig) -> torch.Tensor:
    """2^20 seeded words and the edge words: zero, NaR, minpos, maxpos,
    +-1, the regime bound's first and last words, all-ones fractions."""
    rng = np.random.default_rng(32)
    words = rng.integers(0, 1 << 32, size=1 << 20, dtype=np.uint64)
    rb = min(pc.rcap, 29)         # the bound, or a long run unbounded
    edges = [0, 1 << 31, 1, (1 << 31) - 1, 1 << 30, (1 << 32) - (1 << 30),
             (1 << 30) | ((1 << 30) - 1), (1 << 30) - 1,
             ((1 << rb) - 1) << (31 - rb), 1 << (30 - rb),
             (((1 << rb) - 1) << (31 - rb)) | ((1 << (31 - rb)) - 1),
             (1 << (31 - rb)) - 1]
    edges += [(1 << 32) - e for e in edges if e]
    return torch.from_numpy(np.concatenate(
        [np.asarray(edges, dtype=np.uint64), words]).astype(np.int64))


@pytest.mark.parametrize("variant", VARIANT_NAMES)
def test_pieces_key_promise_p32(variant):
    """The four bounded P32 variants split and keep the promise over 2^20
    seeded words and the edges (the key takes L-21b and L-22b; L-1b and
    L-2b, refused for their six pieces a word, are checked at three val
    and three rem pieces); the four unbounded ones do not split: their
    scales reach -120, where a plane's pieces multiply to less than 2^-126
    (minpos times itself is 2^-240)."""
    cfg = from_variant(32, variant)
    pats = _p32_words(cfg.posit)
    assert (TLM.pieces_key(cfg.posit, cfg) is not None) == (
        variant in ("L-21b", "L-22b"))
    six = (3, 3) if variant in ("L-1b", "L-2b") else None
    admitted = _holds(pats, cfg.posit, cfg, six)
    assert admitted == cfg.bounded
    if not admitted:
        v, _ = decode_planes_raw(pats, cfg.posit, cfg.stages, cfg.trunc,
                                 cfg.sublane)
        nz = v[v != 0].to(torch.float64).abs()
        assert float(nz.min()) ** 2 < NORMAL


def test_pieces_key_counts_and_refusals():
    """The piece counts of Table I's formats, and which it refuses: P32
    L-21b 2 val pieces (17 bits) and 1 rem piece (5 bits), so 5 products;
    the SIMD sub-lane formats one val piece; the unbounded P32 variants,
    with or without sub-lanes, refused (no split), and P32 L-1b and L-2b
    (six pieces a word).  The route: P8 and P16 L-21b to the fp16 kernel,
    P32 L-21b and L-22b and the other P16 variants to the piece kernel,
    what both refuse to the tile kernel."""
    want = {(16, "L-1"): (2, 2), (16, "L-2"): (2, 2), (16, "L-21"): (2, 1),
            (16, "L-22"): (2, 1), (16, "L-1b"): (2, 2), (16, "L-2b"): (2, 2),
            (16, "L-21b"): (2, 1), (16, "L-22b"): (2, 1),
            (32, "L-21b"): (2, 1), (32, "L-22b"): (3, 2)}
    for width in (16, 32):
        for v in VARIANT_NAMES:
            cfg = from_variant(width, v)
            assert TLM.pieces_key(cfg.posit, cfg) == want.get((width, v))
            if (width, v) in ((32, "L-1b"), (32, "L-2b")):
                # 24 significant bits a plane, three pieces each
                assert 2 * TLM._bf16_pieces(24) == 6 > TLM.PIECES_MAX
            kind = TLM.plan_of(128, 9216, 2304, cfg).kind
            assert kind == ("mma" if (width, v) == (16, "L-21b") else
                            "pieces" if (width, v) in want else "tile")
        sub = from_variant(width, "L-21b",
                           simd="8_16" if width == 16 else "8_16_32")
        assert TLM.pieces_key(sub.posit, sub) == ((1, 1) if width == 16
                                                   else (1, 0))
    assert TLM.pieces_key(from_variant(32, "L-21", simd="8_16_32").posit,
                          from_variant(32, "L-21", simd="8_16_32")) is None
    assert [TLM._bf16_pieces(b) for b in (0, 1, 8, 9, 17, 18, 24)] == \
        [0, 1, 1, 2, 2, 3, 3]


def test_p32_planes_equal_jax():
    """The P32 planes the pieces split, bit for bit JAX's
    ``decode_planes_raw`` on the same numpy-seeded words, for the four
    bounded variants."""
    import jax.numpy as jnp
    from repro.core.engine import from_variant as j_variant
    from repro.kernels import logmac as JLM
    for v in ("L-1b", "L-2b", "L-21b", "L-22b"):
        tc, jc = from_variant(32, v), j_variant(32, v)
        pats = _p32_words(tc.posit)
        tv, tr = decode_planes(pats, tc)
        jv, jr = JLM.decode_planes(
            jnp.asarray(pats.numpy().astype(np.uint32)), jc)
        for t, j in ((tv, jv), (tr, jr)):
            assert np.array_equal(t.numpy().view(np.int32),
                                  np.asarray(j).view(np.int32)), v


def _pieces_emulated(a_pat, b_pat, cfg):
    """The kernel's arithmetic: per k16 step, each (A piece, B piece) pair
    in the kernel's order (rem pairs, then val pairs, A and B pieces
    counting down) adds its 16 products (exact, summed in float64) to a
    step sum from zero, rounding once; the step sum is added to the
    running f32 sum."""
    pv, pr = TLM.pieces_key(cfg.posit, cfg)
    va, ra = decode_planes(a_pat, cfg)
    vb, rb = decode_planes(b_pat, cfg)
    pa = TLM.bf16_pieces(va, pv) + TLM.bf16_pieces(ra, pr)
    pb = TLM.bf16_pieces(vb, pv) + TLM.bf16_pieces(-rb, pr)
    np_ = pv + pr
    pairs = [(i, j) for i in reversed(range(np_)) for j in reversed(range(np_))
             if (i < pv) == (j < pv)]
    K = a_pat.shape[1]
    acc = torch.zeros(a_pat.shape[0], b_pat.shape[1], dtype=torch.float32)
    for k0 in range(0, K, 16):
        step = torch.zeros_like(acc)
        for i, j in pairs:
            prod = (pa[i][:, k0:k0 + 16].double()
                    @ pb[j][k0:k0 + 16].double())
            step = (step.double() + prod).to(torch.float32)
        acc = acc + step
    return acc


@pytest.mark.parametrize("variant", ["L-21b", "L-22b", "L-1b"])
@pytest.mark.parametrize("K", [1, 300, 2304])
def test_piece_products_within_the_bound(variant, K):
    """The piece products, accumulated as the kernel does, stay within
    chip_smoke's per-element bound 1e-5 (|va||vb| + |ra||rb|) + 1e-4 of
    the plain version: P32 L-21b and L-22b, and P16 L-1b (two val and two
    rem pieces)."""
    cfg = from_variant(32, variant)
    if TLM.pieces_key(cfg.posit, cfg) is None:       # L-1b: six pieces
        cfg = from_variant(16, variant)
    rng = np.random.default_rng(K)
    a = torch.from_numpy(rng.integers(0, 1 << 32, (33, K)))
    b = torch.from_numpy(rng.integers(0, 1 << 32, (K, 70)))
    got = _pieces_emulated(a, b, cfg)
    va, ra = decode_planes(a, cfg)
    vb, rb = decode_planes(b, cfg)
    bound = 1e-5 * (va.abs() @ vb.abs() + ra.abs() @ rb.abs()) + 1e-4
    assert bool(((got - TLM.logmac_plain(a, b, cfg)).abs() <= bound).all())
