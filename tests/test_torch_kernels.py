"""The port's kernels: plain versions against the JAX kernels in interpret
mode, dispatch by device, and (on a CUDA card only) the kernels against
their plain versions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import posit as JP
from repro.core.engine import from_variant as j_variant
from repro.kernels import logmac as JLM
from repro.kernels import paged_decode as JPD
from repro.kernels import posit_codec as JPC
from repro.kernels import ref as JR
from repro_torch.core import posit as TP
from repro_torch.core.engine import from_variant as t_variant
from repro_torch.kernels import _build
from repro_torch.kernels import logmac as TLM
from repro_torch.kernels import ops as TOps
from repro_torch.kernels import paged_decode as TPD
from repro_torch.kernels import posit_codec as TPC
from repro_torch.kernels import ref as TR
from test_torch_kernel_plans import check_redesigned_kernels_on_card

torch.set_num_threads(1)

FORMATS = [(JP.POSIT8, TP.POSIT8), (JP.BPOSIT8, TP.BPOSIT8),
           (JP.POSIT16, TP.POSIT16), (JP.BPOSIT16, TP.BPOSIT16),
           (JP.POSIT32, TP.POSIT32), (JP.BPOSIT32, TP.BPOSIT32)]
IDS = [j.name for j, _ in FORMATS]


def _rand(rng, shape, scale_pow=6):
    x = rng.normal(size=shape).astype(np.float32)
    return x * np.exp2(rng.integers(-scale_pow, scale_pow,
                                    size=shape)).astype(np.float32)


def _u32(t: torch.Tensor) -> np.ndarray:
    """int32 words (uint32 bits) -> uint32 numpy."""
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("jpc,tpc", FORMATS, ids=IDS)
@pytest.mark.parametrize("shape", [(37,), (64, 33), (5, 7, 11)])
def test_plain_encode_matches_interpret_kernel(jpc, tpc, shape, rng):
    x = _rand(rng, shape, 30)
    x.reshape(-1)[:6] = [0.0, -0.0, np.inf, np.nan, 1e-40, -3e38]
    want = np.asarray(JPC.posit_encode(jnp.asarray(x), jpc, block=128,
                                       interpret=True))
    got = TPC.posit_encode(torch.from_numpy(x), tpc)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(_u32(got), want)
    # the port's oracle (core codec) agrees away from subnormal inputs
    normal = ~((x != 0) & (np.abs(x) < np.float32(2.0 ** -126)))
    oracle = TR.ref_encode(torch.from_numpy(x), tpc).numpy()
    np.testing.assert_array_equal(oracle[normal], want[normal])


@pytest.mark.parametrize("width,variant", [(8, "L-1"), (8, "L-21b"),
                                           (16, "L-2"), (16, "L-21b"),
                                           (32, "L-22b")])
def test_decode_planes_raw_matches(width, variant, rng):
    jc, tc = j_variant(width, variant), t_variant(width, variant)
    pats = rng.integers(0, 1 << min(width, 16), size=512).astype(np.int64)
    jv, jr = JLM.decode_planes_raw(jnp.asarray(pats.astype(np.uint32)),
                                   jc.posit, jc.stages, jc.trunc, jc.sublane)
    tv, tr = TLM.decode_planes_raw(torch.from_numpy(pats), tc.posit,
                                   tc.stages, tc.trunc, tc.sublane)
    # exclude f32-subnormal magnitudes: the host runs XLA with FTZ
    keep = np.abs(np.asarray(jv)) > 2.0 ** -120
    np.testing.assert_allclose(tv.numpy()[keep], np.asarray(jv)[keep],
                               rtol=1e-6)
    np.testing.assert_allclose(tr.numpy()[keep], np.asarray(jr)[keep],
                               rtol=1e-6)
    # and against the port's own core-built oracle
    ov, orr = TR.ref_planes(torch.from_numpy(pats), tc)
    np.testing.assert_allclose(tv.numpy(), ov.numpy(), rtol=1e-6)
    np.testing.assert_allclose(tr.numpy(), orr.numpy(), rtol=1e-6)


@pytest.mark.parametrize("mnk", [(32, 16, 48), (65, 33, 70), (4, 24, 96)])
@pytest.mark.parametrize("variant", ["L-21b", "L-2"])
def test_plain_logmac_matches_interpret_kernel(mnk, variant, rng):
    M, N, K = mnk
    jc, tc = j_variant(16, variant), t_variant(16, variant)
    a = np.asarray(JR.ref_encode(jnp.asarray(_rand(rng, (M, K), 3)),
                                 jc.posit))
    b = np.asarray(JR.ref_encode(jnp.asarray(_rand(rng, (K, N), 3)),
                                 jc.posit))
    want = np.asarray(JLM.logmac(jnp.asarray(a), jnp.asarray(b), jc, bm=32,
                                 bn=32, bk=32, interpret=True))
    got = TOps.logmac_matmul(torch.from_numpy(a.astype(np.int64)),
                             torch.from_numpy(b.astype(np.int64)), tc)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    oracle = TR.ref_logmac(torch.from_numpy(a.astype(np.int64)),
                           torch.from_numpy(b.astype(np.int64)), tc)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=1e-5,
                               atol=1e-4)


def _decode_words(jpc, rng, shape):
    """Words over the format's whole N-bit range, with 0 and NaR first."""
    n = jpc.n_bits
    w = rng.integers(0, 1 << n, size=shape, dtype=np.uint64).astype(np.uint32)
    w.reshape(-1)[:2] = [0, 1 << (n - 1)]
    return w


def _as_words(w: np.ndarray) -> torch.Tensor:
    """uint32 words -> the port's int32 word tensor (same bits)."""
    return torch.from_numpy(w.astype(np.uint32).view(np.int32).copy())


def _assert_bits_equal_outside_ftz(got: np.ndarray, want: np.ndarray):
    """Bit-identical f32 outside |x| < 2^-120, the band this host flushes to
    zero in the interpret-mode kernel (``tests/test_kernels.py:39-44``)."""
    tiny = 2.0 ** -120
    keep = (np.abs(want) >= tiny) & (np.abs(got) >= tiny)
    np.testing.assert_array_equal(got[keep].view(np.uint32),
                                  want[keep].view(np.uint32))
    assert (np.abs(got[~keep]) < tiny).all() or (got[~keep] == 0).all()


@pytest.mark.parametrize("jpc,tpc", FORMATS, ids=IDS)
@pytest.mark.parametrize("shape", [(37,), (64, 33), (5, 7, 11)])
def test_decode_matches_interpret_kernel(jpc, tpc, shape, rng):
    """ops.decode (plain version on the CPU) against the TPU decode kernel
    in interpret mode; zero and NaR decode to 0.0 in both."""
    w = _decode_words(jpc, rng, shape)
    want = np.asarray(JPC.posit_decode(jnp.asarray(w), jpc, block=128,
                                       interpret=True))
    got = TOps.decode(_as_words(w), tpc)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    got = got.numpy()
    assert got.reshape(-1)[:2].tolist() == [0.0, 0.0]
    assert want.reshape(-1)[:2].tolist() == [0.0, 0.0]
    _assert_bits_equal_outside_ftz(got, want)


@pytest.mark.parametrize("jpc,tpc", FORMATS, ids=IDS)
def test_decode_every_pattern_matches_interpret_kernel(jpc, tpc, rng):
    """Every 8/16-bit pattern; for 32-bit formats 2^16 words drawn over the
    whole 32-bit range (beyond the 16-bit range the JAX test draws)."""
    if jpc.n_bits <= 16:
        w = np.arange(1 << jpc.n_bits, dtype=np.uint32)
    else:
        w = _decode_words(jpc, rng, (1 << 16,))
    want = np.asarray(JPC.posit_decode(jnp.asarray(w), jpc, block=4096,
                                       interpret=True))
    _assert_bits_equal_outside_ftz(TOps.decode(_as_words(w), tpc).numpy(),
                                   want)


@pytest.mark.parametrize("jpc,tpc", FORMATS, ids=IDS)
def test_decode_matches_core_codec(jpc, tpc, rng):
    """Against the core codec's decode_to_float at the JAX suite's bar
    (``test_kernels.py:39-44``): rtol 1e-6, NaR and |x| < 2^-120 excluded
    (the core decode gives NaN for NaR, the kernel 0.0)."""
    w = _decode_words(jpc, rng, (4096,))
    got = TOps.decode(_as_words(w), tpc).numpy()
    for want in (np.asarray(JR.ref_decode(jnp.asarray(w), jpc)),
                 TP.decode_to_float(torch.from_numpy(w.astype(np.int64)),
                                    tpc).numpy()):
        mask = ~np.isnan(want) & (np.abs(want) > 2.0 ** -120)
        np.testing.assert_allclose(got[mask], want[mask], rtol=1e-6)
        assert got[np.isnan(want)].tolist() == [0.0] * int(
            np.isnan(want).sum())


def test_plain_logmac_column_chunks_are_exact(rng):
    tc = t_variant(16, "L-21b")
    a = TPC.posit_encode(torch.from_numpy(_rand(rng, (5, 40), 3)), tc.posit)
    b = TPC.posit_encode(torch.from_numpy(_rand(rng, (40, 70), 3)), tc.posit)
    whole = TLM.logmac_plain(a, b, tc, n_chunk=1 << 20)
    chunked = TLM.logmac_plain(a, b, tc, n_chunk=16)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)


@pytest.mark.parametrize("width", [8, 16, 32])
def test_fused_path_matches_reference(width, rng):
    jc = j_variant(width, "L-21b", pre_scale=False)
    tc = t_variant(width, "L-21b", pre_scale=False)
    x = rng.normal(size=(12, 64)).astype(np.float32)
    w = rng.normal(size=(64, 24)).astype(np.float32)
    from repro.kernels import ops as JOps
    want = np.asarray(JOps.euler_matmul_fused(jnp.asarray(x), jnp.asarray(w),
                                              jc, interpret=True, bm=16,
                                              bn=8, bk=32))
    got = TOps.euler_matmul_fused(torch.from_numpy(x), torch.from_numpy(w),
                                  tc)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def _pages(rng, B, KV, group, hd, ps, nlp, pcj):
    num_pages = JPD.RESERVED_PAGES + B * nlp
    kf = rng.standard_normal((num_pages, ps, KV, hd)).astype(np.float32)
    vf = rng.standard_normal((num_pages, ps, KV, hd)).astype(np.float32)
    kf[:JPD.RESERVED_PAGES] = 0.0
    vf[:JPD.RESERVED_PAGES] = 0.0
    kw = np.asarray(JP.to_storage(JP.encode_from_float(jnp.asarray(kf), pcj),
                                  pcj))
    vw = np.asarray(JP.to_storage(JP.encode_from_float(jnp.asarray(vf), pcj),
                                  pcj))
    q = rng.standard_normal((B, 1, KV * group, hd)).astype(np.float32)
    return q, kw, vw


def _as_storage(words: np.ndarray) -> torch.Tensor:
    signed = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32}
    dt = signed.get(words.dtype)
    return torch.from_numpy(np.array(words.view(dt) if dt else words))


@pytest.mark.parametrize("window", [None, 4096, 6])
@pytest.mark.parametrize("fmt", ["bposit16", "posit8"])
def test_plain_flash_decode_matches_interpret_kernel(window, fmt):
    rng = np.random.default_rng(7)
    B, KV, group, hd, ps, nlp = 3, 2, 2, 24, 8, 4
    pcj, pct = ((JP.BPOSIT16, TP.BPOSIT16) if fmt == "bposit16"
                else (JP.POSIT8, TP.POSIT8))
    q, kw, vw = _pages(rng, B, KV, group, hd, ps, nlp, pcj)
    table = np.asarray([[2, 3, 4, 0], [5, 0, 0, 0], [6, 7, 8, 9]], np.int32)
    pos = np.asarray([19, 5, 30], np.int32)
    jc, tc = j_variant(16, "L-21b"), t_variant(16, "L-21b")
    want = np.asarray(JPD.paged_flash_decode(
        jnp.asarray(q), jnp.asarray(kw), jnp.asarray(vw), jnp.asarray(table),
        jnp.asarray(pos), window, pc=pcj, cfg_qk=jc, cfg_pv=jc, softcap=50.0,
        interpret=True))
    args = (torch.from_numpy(q), _as_storage(kw), _as_storage(vw),
            torch.from_numpy(table), torch.from_numpy(pos), window)
    kw_t = dict(pc=pct, cfg_qk=tc, cfg_pv=tc, softcap=50.0)
    got = TPD.paged_flash_decode(*args, **kw_t).numpy()
    assert got.shape == want.shape == (B, 1, KV * group * hd)
    assert np.abs(got - want).max() <= 1e-3
    ref = TPD.paged_attention_reference(
        torch.from_numpy(q), _as_storage(kw), _as_storage(vw),
        torch.from_numpy(table), torch.from_numpy(pos), pc=pct, softcap=50.0,
        window=window).numpy()
    assert np.abs(got - ref).max() < 0.05


@pytest.mark.parametrize("window", [None, 4096, 6])
def test_paged_attention_reference_matches(window):
    rng = np.random.default_rng(3)
    B, KV, group, hd, ps, nlp = 2, 2, 2, 16, 8, 3
    q, kw, vw = _pages(rng, B, KV, group, hd, ps, nlp, JP.POSIT16)
    table = np.asarray([[2, 3, 0], [4, 5, 6]], np.int32)
    pos = np.asarray([11, 20], np.int32)
    want = np.asarray(JPD.paged_attention_reference(
        jnp.asarray(q), jnp.asarray(kw), jnp.asarray(vw), jnp.asarray(table),
        jnp.asarray(pos), pc=JP.POSIT16, softcap=50.0, window=window))
    got = TPD.paged_attention_reference(
        torch.from_numpy(q), _as_storage(kw), _as_storage(vw),
        torch.from_numpy(table), torch.from_numpy(pos), pc=TP.POSIT16,
        softcap=50.0, window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_gather_pages_matches():
    pages = np.arange(5 * 4 * 3, dtype=np.float32).reshape(5, 4, 3)
    table = np.asarray([[2, 0], [4, 3]], np.int32)
    want = np.asarray(JPD.gather_pages(jnp.asarray(pages),
                                       jnp.asarray(table)))
    got = TPD.gather_pages(torch.from_numpy(pages), torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (TPD.NULL_PAGE, TPD.TRASH_PAGE, TPD.RESERVED_PAGES) == \
        (JPD.NULL_PAGE, JPD.TRASH_PAGE, JPD.RESERVED_PAGES)


def test_cuda_backend_on_cpu_runs_plain_versions():
    """CPU tensors take the plain versions: no kernel launch is counted,
    and the result equals the plain path's."""
    from repro_torch.numerics import NumericsContext, dot_general
    _build.reset_launches()
    tc = t_variant(16, "L-21b")
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(4, 32, generator=g), torch.randn(32, 16, generator=g)
    dn = (((1,), (0,)), ((), ()))
    out = dot_general(x, w, dn, NumericsContext.from_ecfg(tc, "cuda"),
                      op="matmul")
    assert tuple(out.shape) == (4, 16)
    rng = np.random.default_rng(0)
    q, kw, vw = _pages(rng, 1, 1, 2, 8, 4, 2, JP.BPOSIT16)
    TPD.paged_flash_decode(torch.from_numpy(q), _as_storage(kw),
                           _as_storage(vw), torch.tensor([[2, 3]],
                                                         dtype=torch.int32),
                           torch.tensor([5], dtype=torch.int32),
                           pc=TP.BPOSIT16, cfg_qk=tc, cfg_pv=tc)
    TOps.decode(torch.zeros(8, dtype=torch.int32), TP.BPOSIT16)
    assert _build.LAUNCHES == {"posit_encode": 0,
                               "posit_encode_prescaled": 0,
                               "posit_decode": 0, "posit_store": 0,
                               "posit_load": 0, "posit_quantize": 0,
                               "posit_quantize_prescaled": 0,
                               "posit_sentinels": 0, "logmac": 0,
                               "logmac_small": 0, "logmac_mma": 0,
                               "logmac_pieces": 0, "logmac_tile": 0,
                               "paged_flash_decode": 0}
    assert all(not v for v in _build.WIDTH_LAUNCHES.values())


def test_wrappers_refuse_other_devices():
    tc = t_variant(16, "L-21b")
    x = torch.zeros(4, 4, device="meta")
    with pytest.raises(ValueError):
        TPC.posit_encode(x, tc.posit)
    with pytest.raises(ValueError):
        TPC.posit_encode_prescaled(x, tc.posit)
    with pytest.raises(ValueError):
        TLM.logmac(x.to(torch.int32), x.to(torch.int32), tc)
    with pytest.raises(ValueError):
        TOps.decode(x.to(torch.int32), tc.posit)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    """Each kernel against its plain version on a CUDA card (chip_smoke.py
    runs the same checks at the full gemma2-2b shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    tc = t_variant(16, "L-21b")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(3000, generator=g, device=dev)
    for pc in (TP.POSIT8, TP.BPOSIT16, TP.POSIT32):
        assert bool((TPC.posit_encode(x, pc) == TPC.encode_plain(x, pc)).all())
    w = torch.randint(-(1 << 31), (1 << 31) - 1, (3000,), generator=g,
                      dtype=torch.int32, device=dev)
    for pc in (TP.POSIT8, TP.BPOSIT16, TP.POSIT32, TP.BPOSIT32):
        got, want = TPC.posit_decode(w, pc), TPC.decode_plain(w, pc)
        assert bool((got.view(torch.int32) == want.view(torch.int32)).all())
    for width in (8, 16, 32):
        tc = t_variant(width, "L-21b")
        a = TPC.posit_encode(torch.randn(4, 300, generator=g, device=dev),
                             tc.posit)
        b = TPC.posit_encode(torch.randn(300, 70, generator=g, device=dev),
                             tc.posit)
        torch.testing.assert_close(TLM.logmac(a, b, tc),
                                   TLM.logmac_plain(a, b, tc), rtol=1e-5,
                                   atol=1e-4)
    # the small-M logmac's and paged decode's edge shapes
    check_redesigned_kernels_on_card(dev)
