"""The core codec's entries (``kernels/posit_codec.py``: ``posit_store``,
``posit_load``, ``posit_quantize``; ``csrc/posit_core_codec.cu`` on a card)
and the six call sites routed through them.

* Bit for bit (NaN as NaN) against the JAX package's core codec on the
  CPU: every 8- and 16-bit pattern and 2^16 seeded 32-bit words decoded to
  f32 and bf16, f32 edge values and seeded floats encoded and quantized,
  the uint8 / int16 / int32 storage words, and the JAX call sites
  (``cache_encode`` / ``cache_decode``, the guard's ``_quantize_like``).
  Subnormal inputs included: XLA flushes them to zero, on its CPU runtime
  as on a TPU, and so does the port (a subnormal encodes to 0, and a
  product ``q * s`` that goes subnormal is a signed 0).
* A spy: each call site (the KV-cache write and read, paged decode's
  gather reference, the guard's quantize check and sentinels, fault
  injection, ``out_quant``) goes through its entry.  The guard's two
  fused entries (``posit_quantize_prescaled``, ``posit_sentinels``) are
  held in ``test_torch_guard_kernels.py``.
* On a card (``cuda`` marker; skips here): each entry bit for bit against
  its plain version.  This file imports JAX inside a fixture only, so it
  runs on a machine with torch alone:
  ``python -m pytest --noconftest -m cuda tests/test_torch_core_codec.py``.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.core import engine as TE
from repro_torch.core import posit as TP
from repro_torch.kernels import _build
from repro_torch.kernels import ops as TOps
from repro_torch.kernels import paged_decode as TPD
from repro_torch.kernels import posit_codec as TPC
from repro_torch.models import layers as TL
from repro_torch.reliability import faults as TF
from repro_torch.reliability import guards as TG

torch.set_num_threads(1)

FORMATS = [(8, 0, None), (8, 0, 2), (16, 1, None), (16, 1, 3), (32, 2, None),
           (32, 2, 5)]
EDGES = np.array(
    [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1.0, -1.0, 0.5, 1.5,
     2.0 ** -126, -2.0 ** -126, 2.0 ** -125, 3.4028235e38, -3.4028235e38,
     1e30, -1e30, 1e-30, -1e-30]
    # each format's clamp edges: minpos and maxpos, a step beyond, and a
    # value between
    + [v for e in (6, 12, 20, 28, 56, 120)
       for v in (2.0 ** e, 2.0 ** (e + 1), 3 * 2.0 ** e, 2.0 ** -e,
                 2.0 ** -(e + 1), 1.5 * 2.0 ** -(e + 1), -2.0 ** -e)],
    np.float32)
SUBNORMALS = np.array([1e-40, -1e-40, 1.4e-45, -1.4e-45, 1.1754942e-38,
                       -1.1754942e-38, 5e-39], np.float32)


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules (imported here, so the card test runs
    where JAX is missing)."""
    import jax.numpy as jnp
    from repro.core import engine as JE
    from repro.core import posit as JP
    from repro.models import layers as JL
    from repro.reliability import guards as JG
    return types.SimpleNamespace(jnp=jnp, JE=JE, JP=JP, JL=JL, JG=JG)


def _pcs(J, fmt):
    return TP.PositConfig(*fmt), J.JP.PositConfig(*fmt)


def _same(got, want) -> int:
    """Values that differ in their bits, NaN counted equal to any NaN."""
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = np.isnan(got.astype(np.float32)) & np.isnan(want.astype(np.float32))
    ib = {2: np.uint16, 4: np.uint32}[got.dtype.itemsize]
    return int(((got.view(ib) != want.view(ib)) & ~nan).sum())


def _bf16(t: torch.Tensor) -> np.ndarray:
    """A torch bf16 tensor as numpy bf16 bits (ml_dtypes' bfloat16)."""
    import ml_dtypes
    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def _words(fmt, rng) -> np.ndarray:
    n = fmt[0]
    if n <= 16:
        return np.arange(1 << n, dtype=np.uint32)
    return np.concatenate([
        rng.integers(0, 1 << 32, 1 << 16, dtype=np.uint64).astype(np.uint32),
        np.array([0, 1, 2, 1 << 31, (1 << 31) - 1, (1 << 31) + 1,
                  (1 << 32) - 1], np.uint32)])


def _floats(rng, n=4096) -> np.ndarray:
    x = rng.standard_normal(n) * np.exp2(rng.integers(-40, 40, n))
    return np.concatenate([x.astype(np.float32), EDGES])


@pytest.mark.parametrize("fmt", FORMATS, ids=str)
def test_load_matches_jax_decode(J, fmt):
    """``posit_load`` of every storage word against JAX's
    ``decode_to_float(from_storage(words))`` in f32 and bf16."""
    tpc, jpc = _pcs(J, fmt)
    w = _words(fmt, np.random.default_rng(fmt[0] + (fmt[2] or 0)))
    words = TP.to_storage(torch.from_numpy(w.astype(np.int64)), tpc)
    assert words.dtype == tpc.storage_dtype
    jw = J.JP.from_storage(J.jnp.asarray(words.numpy()).astype(
        {8: J.jnp.uint8, 16: J.jnp.uint16, 32: J.jnp.uint32}[fmt[0]]), jpc)
    got32 = TPC.posit_load(words, tpc, torch.float32).numpy()
    want32 = np.asarray(J.JP.decode_to_float(jw, jpc, J.jnp.float32))
    assert _same(got32, want32) == 0
    got16 = _bf16(TPC.posit_load(words, tpc, torch.bfloat16))
    want16 = np.asarray(J.JP.decode_to_float(jw, jpc, J.jnp.bfloat16))
    assert _same(got16, want16) == 0
    nar = w == (1 << (fmt[0] - 1))
    assert np.isnan(got32[nar]).all() and not np.isnan(got32[~nar]).any()


@pytest.mark.parametrize("fmt", FORMATS, ids=str)
def test_store_and_quantize_match_jax(J, fmt):
    """``posit_store`` against JAX's ``to_storage(encode_from_float(x))``,
    ``posit_quantize`` against ``quantize(x)`` and ``quantize_plain``
    (the guard entry's values) against ``quantize(x / s) * s`` (s the pow2
    scale), on seeded floats and the edge values; subnormal inputs, f32
    and bf16, and quotients and products that go subnormal, against the
    JAX functions (XLA's flush: 0 and signed 0)."""
    tpc, jpc = _pcs(J, fmt)
    x = _floats(np.random.default_rng(7))
    xt = torch.from_numpy(x.copy())
    got = TPC.posit_store(xt, tpc)
    assert got.dtype == tpc.storage_dtype
    want = np.asarray(J.JP.to_storage(J.JP.encode_from_float(
        J.jnp.asarray(x), jpc), jpc))
    m = (1 << fmt[0]) - 1
    assert ((got.numpy().astype(np.int64) & m)
            == (want.astype(np.int64) & m)).all()
    for tdt, jdt in ((torch.float32, J.jnp.float32),
                     (torch.bfloat16, J.jnp.bfloat16)):
        sub = TPC.posit_store(torch.from_numpy(SUBNORMALS.copy()).to(tdt),
                              tpc)
        jsub = np.asarray(J.JP.to_storage(J.JP.encode_from_float(
            J.jnp.asarray(SUBNORMALS).astype(jdt), jpc), jpc))
        assert ((sub.numpy().astype(np.int64) & m).tolist()
                == (jsub.astype(np.int64) & m).tolist())
        # in bf16 1.1754942e-38 and -1.1754942e-38 round to +-2^-126
        assert not sub.numpy().any() or tdt == torch.bfloat16

    s = TE._pow2_scale(xt[torch.isfinite(xt)])
    js = J.jnp.float32(float(s))
    jx = J.jnp.asarray(x)
    got = TPC.posit_quantize(xt, tpc).numpy()
    assert _same(got, np.asarray(J.JP.quantize(jx, jpc))) == 0
    got = TPC.quantize_plain(xt, tpc, s).numpy()
    assert _same(got, np.asarray(J.JP.quantize(jx / js, jpc) * js)) == 0
    # quotients x / s below 2^-126 (XLA flushes them: word 0), and
    # products q * s below it (XLA flushes them: a signed 0)
    tiny = np.array([3e-39, -3e-39, 1e-45, 1.0, -1.0, 2.0 ** -100],
                    np.float32)
    for sv in (2.0 ** 20, 2.0 ** -40, 1e-30):
        got = TPC.quantize_plain(torch.from_numpy(tiny * np.float32(sv)),
                                 tpc, torch.tensor(sv)).numpy()
        sj = J.jnp.float32(sv)
        want = np.asarray(J.JP.quantize(J.jnp.asarray(tiny * np.float32(sv))
                                        / sj, jpc) * sj)
        assert _same(got, want) == 0, (sv, got, want)


@pytest.mark.parametrize("cache_dtype", ["uint8", "uint16", "uint32"])
@pytest.mark.parametrize("policy", [False, True], ids=["storage", "policy"])
def test_cache_codec_matches_jax(J, cache_dtype, policy):
    """The KV-cache write and read against JAX's ``cache_encode`` /
    ``cache_decode``, f32 and bf16 in and out, with the storage width's
    standard format or the policy's bounded one."""
    width = int(cache_dtype[4:])
    fmt = {8: (8, 0, 2), 16: (16, 1, 3), 32: (32, 2, 5)}[width]
    tpc, jpc = _pcs(J, fmt) if policy else (None, None)
    rng = np.random.default_rng(width)
    x = rng.standard_normal((2, 3, 4, 24)).astype(np.float32) * 3
    x.reshape(-1)[:EDGES.size] = EDGES
    tdt = TP.STORAGE_DTYPES[cache_dtype]
    jdt = getattr(J.jnp, cache_dtype)
    for in_dt, jin in ((torch.float32, J.jnp.float32),
                       (torch.bfloat16, J.jnp.bfloat16)):
        xt = torch.from_numpy(x).to(in_dt)
        jx = J.jnp.asarray(x).astype(jin)
        got = TL.cache_encode(xt, tdt, tpc)
        want = np.asarray(J.JL.cache_encode(jx, jdt, jpc))
        assert got.dtype == tdt
        assert (got.numpy().view(want.dtype) == want).all()
        for out_dt, jout in ((torch.float32, J.jnp.float32),
                             (torch.bfloat16, J.jnp.bfloat16)):
            dec = TL.cache_decode(got, out_dt, tpc)
            jdec = np.asarray(J.JL.cache_decode(J.jnp.asarray(want), jout,
                                                jpc))
            dec = _bf16(dec) if out_dt == torch.bfloat16 else dec.numpy()
            assert _same(dec, jdec) == 0


@pytest.mark.parametrize("variant", [(16, "L-21b"), (8, "L-21b"),
                                     (32, "L-1b")], ids=str)
def test_guard_quantize_matches_jax(J, variant):
    """The guard's check operand (``_quantize_like``) against JAX's, with
    and without pre-scale, on a contiguous and a transposed operand."""
    rng = np.random.default_rng(variant[0])
    x = (rng.standard_normal((48, 40))
         * np.exp2(rng.integers(-12, 12, (48, 40)))).astype(np.float32)
    x.reshape(-1)[:EDGES.size] = EDGES
    for pre_scale in (True, False):
        tcfg = TE.from_variant(*variant, pre_scale=pre_scale)
        jcfg = J.JE.from_variant(*variant, pre_scale=pre_scale)
        for xt, xj in ((torch.from_numpy(x), x),
                       (torch.from_numpy(x).t(), x.T)):
            got = TG._quantize_like(xt, tcfg).numpy()
            want = np.asarray(J.JG._quantize_like(J.jnp.asarray(xj), jcfg))
            assert _same(got, want) == 0


def test_the_call_sites_go_through_the_entries(monkeypatch):
    """Each of the six call sites calls its entry of ``posit_codec``."""
    seen = []

    def spy(name):
        inner = getattr(TPC, name)

        def wrapped(*args, **kw):
            seen.append(name)
            return inner(*args, **kw)
        monkeypatch.setattr(TPC, name, wrapped)

    for name in ("posit_store", "posit_load", "posit_quantize",
                 "posit_quantize_prescaled", "posit_sentinels"):
        spy(name)

    def calls(fn):
        seen.clear()
        fn()
        return list(seen)

    pc = TP.BPOSIT16
    cfg = TE.from_variant(16, "L-21b")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 2, 8, generator=g)
    words = TL.cache_encode(x, torch.int16, pc)
    assert calls(lambda: TL.cache_encode(x, torch.int16, pc)) == [
        "posit_store"]
    assert calls(lambda: TL.cache_decode(words, torch.bfloat16, pc)) == [
        "posit_load"]
    assert calls(lambda: TPD.decode_words(words, pc)) == ["posit_load"]
    assert calls(lambda: TG._quantize_like(x, cfg)) == [
        "posit_quantize_prescaled"]
    assert calls(lambda: TG._quantize_like(
        x, cfg.replace(pre_scale=False))) == ["posit_quantize"]
    assert calls(lambda: TG.sentinel_counts(x, cfg)) == ["posit_sentinels"]
    plan = TF.FaultPlan(rate=0.5)
    assert calls(lambda: TF.corrupt(x, cfg, plan, 1, 0)) == [
        "posit_store", "posit_load"]
    from repro_torch.numerics import backends as TB
    oq = cfg.replace(out_quant=True)
    a, b = torch.randn(3, 16, generator=g), torch.randn(16, 5, generator=g)
    dn = (((1,), (0,)), ((), ()))
    assert calls(lambda: TB.get_backend("cuda").dot_general(
        a, b, dn, oq)) == ["posit_quantize"]
    assert calls(lambda: TOps.quantize(a, pc)) == ["posit_quantize"]


def test_entries_on_meta_tensors_give_shapes():
    """The dry run's ``meta`` tensors take the plain version: shapes and
    dtypes, no launch."""
    _build.reset_launches()
    x = torch.empty(3, 5, device="meta")
    assert TPC.posit_store(x, TP.POSIT16).dtype == torch.int16
    assert TPC.posit_load(torch.empty(3, 5, dtype=torch.uint8,
                                      device="meta"), TP.POSIT8,
                          torch.bfloat16).shape == (3, 5)
    assert TPC.posit_quantize(x, TP.POSIT32).device.type == "meta"
    assert _build.LAUNCHES["posit_store"] == 0


def test_in_place_layouts():
    """A tensor whose elements fill one block (a transpose, a permutation)
    is read in place and its output laid out alike; a strided slice is
    copied first."""
    x = torch.arange(24.0).reshape(2, 3, 4)
    for v in (x, x.t() if x.ndim == 2 else x.permute(2, 0, 1),
              x.transpose(0, 1)):
        got = TPC._in_place(v)
        assert got.data_ptr() == v.data_ptr()
        out = torch.empty_like(got, dtype=torch.int16)
        assert out.stride() == got.stride()
    sl = x[:, 0]
    assert TPC._in_place(sl).is_contiguous() and torch.equal(
        TPC._in_place(sl), sl)


def check_core_codec_on_card(dev: torch.device) -> None:
    """Each entry bit for bit (NaN as NaN) against its plain version on the
    card, every dtype, a transposed and a strided operand, and one launch
    counted a call (chip_smoke.py phase 2 holds them at full size)."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(4099, generator=g, device=dev) * torch.exp2(
        torch.randint(-40, 40, (4099,), generator=g, device=dev).float())
    x = torch.cat([x, torch.from_numpy(np.concatenate([EDGES, SUBNORMALS]))
                   .to(dev)])

    def same(a, b):
        nan = torch.isnan(a.float()) & torch.isnan(b.float())
        ib = torch.int16 if a.element_size() == 2 else torch.int32
        return bool(((a.view(ib) == b.view(ib)) | nan).all())

    for fmt in FORMATS:
        pc = TP.PositConfig(*fmt)
        for xi in (x, x.to(torch.bfloat16)):
            before = _build.LAUNCHES["posit_store"]
            assert torch.equal(TPC.posit_store(xi, pc),
                               TPC.store_plain(xi, pc))
            assert _build.LAUNCHES["posit_store"] == before + 1
        n = fmt[0]
        w = (torch.arange(1 << n, device=dev) if n <= 16 else torch.randint(
            0, 1 << 32, (1 << 20,), generator=g, device=dev))
        words = TP.to_storage(w, pc)
        for dt in (torch.float32, torch.bfloat16):
            assert same(TPC.posit_load(words, pc, dt),
                        TPC.load_plain(words, pc, dt))
        assert same(TPC.posit_quantize(x, pc), TPC.quantize_plain(x, pc))
        m = x[:4096].reshape(64, 64)
        assert same(TPC.posit_quantize(m.t(), pc),
                    TPC.quantize_plain(m.t(), pc))
        assert torch.equal(TPC.posit_store(m[:, ::3], pc),
                           TPC.store_plain(m[:, ::3], pc))
    with pytest.raises(ValueError):
        TPC.posit_quantize(x.to(torch.bfloat16), TP.POSIT16)
    with pytest.raises(ValueError):
        TPC.posit_store(x.half(), TP.POSIT16)


@pytest.mark.cuda
def test_core_codec_matches_plain_versions_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    check_core_codec_on_card(torch.device("cuda"))
