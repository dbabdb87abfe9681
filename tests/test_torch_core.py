"""Parity of the port's core (posit codec, ILM planes, engine, policies)
with the JAX reference: the same numpy inputs through both packages."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.core import logmult as JL
from repro.core import posit as JP
from repro.numerics import policy as JPol
from repro_torch.core import engine as TE
from repro_torch.core import logmult as TL
from repro_torch.core import posit as TP
from repro_torch.numerics import policy as TPol

torch.set_num_threads(1)

FORMATS = [(JP.POSIT8, TP.POSIT8), (JP.BPOSIT8, TP.BPOSIT8),
           (JP.POSIT16, TP.POSIT16), (JP.BPOSIT16, TP.BPOSIT16),
           (JP.POSIT32, TP.POSIT32), (JP.BPOSIT32, TP.BPOSIT32)]
IDS = [j.name for j, _ in FORMATS]


def _patterns(pc, rng):
    """Every word for 8/16-bit formats; a seeded sample plus the special
    words for 32-bit ones."""
    if pc.n_bits <= 16:
        return np.arange(1 << pc.n_bits, dtype=np.int64)
    sample = rng.integers(0, 1 << 32, size=1 << 16, dtype=np.int64)
    return np.concatenate([sample, [0, 1, 1 << 31, (1 << 32) - 1,
                                    (1 << 31) - 1, (1 << 31) + 1]])


def _floats(rng, n=20000, spread=40):
    x = rng.normal(size=n) * np.exp2(rng.integers(-spread, spread, size=n))
    return np.concatenate([x, [0.0, -0.0, np.inf, -np.inf, np.nan, 3e38,
                               -3e38, 1.0, -1.0, 0.5]]).astype(np.float32)


@pytest.mark.parametrize("jpc,tpc", FORMATS, ids=IDS)
def test_decode_fields_bit_exact(jpc, tpc, rng):
    pats = _patterns(jpc, rng)
    want = JP.decode_fields(jnp.asarray(pats.astype(np.uint32)), jpc)
    got = TP.decode_fields(torch.from_numpy(pats), tpc)
    for k in ("sign", "scale", "frac", "is_zero", "is_nar"):
        np.testing.assert_array_equal(got[k].numpy().astype(np.int64),
                                      np.asarray(want[k]).astype(np.int64),
                                      err_msg=k)
    assert got["frac_window"] == want["frac_window"]


@pytest.mark.parametrize("jpc,tpc", FORMATS, ids=IDS)
def test_decode_to_float_bit_exact(jpc, tpc, rng):
    pats = _patterns(jpc, rng)
    want = np.asarray(JP.decode_to_float(jnp.asarray(pats.astype(np.uint32)),
                                         jpc))
    got = TP.decode_to_float(torch.from_numpy(pats), tpc).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("jpc,tpc", FORMATS, ids=IDS)
def test_encode_from_float_bit_exact(jpc, tpc, rng):
    """Encode of every decoded value (all words for 8/16 bits), their
    midpoints, and wide-range random floats."""
    vals = np.asarray(JP.decode_to_float(
        jnp.asarray(_patterns(jpc, rng).astype(np.uint32)), jpc))
    vals = np.sort(vals[np.isfinite(vals)]).astype(np.float64)
    mids = ((vals[1:] + vals[:-1]) / 2).astype(np.float32)
    # subnormals included: XLA flushes them to zero, and so does the port
    x = np.concatenate([vals.astype(np.float32), mids, _floats(rng),
                        np.asarray([1e-40, -1e-40, 1.4e-45, -5e-39],
                                   np.float32)])
    want = np.asarray(JP.encode_from_float(jnp.asarray(x), jpc))
    got = TP.encode_from_float(torch.from_numpy(x), tpc).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("jpc,tpc", FORMATS, ids=IDS)
def test_encode_subnormals_match_bigint_oracle(jpc, tpc):
    """Subnormal f32 and bf16 inputs encode to 0 and quantize to 0 as the
    JAX functions give them under XLA's flush (the exact big-int oracle
    ``np_encode`` would give +-minpos: it knows no flush)."""
    x = np.asarray([1e-40, -1e-40, 2.0 ** -140, -(2.0 ** -127), 1.4e-45,
                    -1.1754942e-38], np.float32)
    assert [JP.np_encode(float(v), jpc) for v in x[:2]] == [
        1, (1 << jpc.n_bits) - 1]
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        jx = jnp.asarray(x).astype(jdt)
        tx = torch.from_numpy(x).to(tdt)
        want = np.asarray(JP.encode_from_float(jx, jpc)).astype(np.int64)
        np.testing.assert_array_equal(
            TP.encode_from_float(tx, tpc).numpy(), want)
        # in bf16 -1.1754942e-38 rounds to -2^-126, a normal value
        assert not want[:-1].any()
        np.testing.assert_array_equal(TP.quantize(tx, tpc).numpy(),
                                      np.asarray(JP.quantize(jx, jpc)))


@pytest.mark.parametrize("jpc,tpc", FORMATS, ids=IDS)
def test_quantize_and_storage_roundtrip(jpc, tpc, rng):
    x = _floats(rng, 4000, 12)
    want = np.asarray(JP.quantize(jnp.asarray(x), jpc))
    got = TP.quantize(torch.from_numpy(x), tpc).numpy()
    np.testing.assert_array_equal(got, want)
    pat = TP.encode_from_float(torch.from_numpy(x), tpc)
    words = TP.to_storage(pat, tpc)
    assert words.dtype == tpc.storage_dtype
    np.testing.assert_array_equal(TP.from_storage(words, tpc).numpy(),
                                  pat.numpy())
    jw = np.asarray(JP.to_storage(JP.encode_from_float(jnp.asarray(x), jpc),
                                  jpc))
    np.testing.assert_array_equal(words.numpy().view(jw.dtype), jw)


def test_storage_pc_follows_width_and_preference():
    assert TP.storage_pc(torch.uint8) == TP.POSIT8
    assert TP.storage_pc(torch.int16) == TP.POSIT16
    assert TP.storage_pc(torch.int32, TP.BPOSIT32) == TP.BPOSIT32
    assert TP.storage_pc(torch.int16, TP.BPOSIT8) == TP.POSIT16
    assert TP.storage_pc(torch.float32) is None
    assert TP.storage_pc(torch.bfloat16, TP.BPOSIT16) is None


@pytest.mark.parametrize("n", [7, 15, 31])
def test_leading_run_matches_bit_loop(n, rng):
    """``leading_run`` (bit length from a float64 frexp) against the plain
    scan of the top bits it replaces, for both run polarities and several
    depths: every body for n <= 15, a seeded sample for n = 31."""
    body = torch.from_numpy(np.arange(1 << n, dtype=np.int64) if n <= 15
                            else rng.integers(0, 1 << n, 1 << 16))
    for r0 in ((body >> (n - 1)) & 1, 1 - ((body >> (n - 1)) & 1)):
        for depth in (2, 5, n):
            run = torch.zeros_like(body)
            cont = torch.ones_like(body, dtype=torch.bool)
            for j in range(depth):
                cont = cont & (((body >> (n - 1 - j)) & 1) == r0)
                run = run + cont.to(body.dtype)
            assert torch.equal(TP.leading_run(body, n, r0, depth), run)


@pytest.mark.parametrize("k", [0, 1, 3, 6])
def test_clear_top_set_bits_exact(k, rng):
    x = rng.integers(0, 1 << 31, size=5000, dtype=np.int64)
    want = np.asarray(JL.clear_top_set_bits(jnp.asarray(x.astype(np.uint32)),
                                            k)).astype(np.int64)
    got = TL.clear_top_set_bits(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got[:50], [JL.np_clear_top_set_bits(int(v), k) for v in x[:50]])


@pytest.mark.parametrize("width,variant", [(8, "L-1"), (8, "L-21b"),
                                           (16, "L-2"), (16, "L-21b"),
                                           (32, "L-22b")])
def test_ilm_planes_match_reference(width, variant, rng):
    jc, tc = JE.from_variant(width, variant), TE.from_variant(width, variant)
    x = rng.normal(size=3000).astype(np.float32) * 4
    jv, jr = JL.ilm_planes_from_float(jnp.asarray(x), jc.posit, jc.stages,
                                      jc.trunc, jc.sublane)
    tv, tr = TL.ilm_planes_from_float(torch.from_numpy(x), tc.posit,
                                      tc.stages, tc.trunc, tc.sublane)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6)


def test_euler_config_variants_match():
    for w in (8, 16, 32):
        for v in JE.VARIANT_NAMES:
            j, t = JE.from_variant(w, v), TE.from_variant(w, v)
            assert (j.stages, j.trunc, j.bounded, j.width) == \
                (t.stages, t.trunc, t.bounded, t.width)
            assert j.variant == t.variant
            assert j.posit.name == t.posit.name
            assert j.sublane == t.sublane


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_pow2_scale_matches(scale, rng):
    x = (rng.normal(size=(17, 33)) * scale).astype(np.float32)
    x[0, :5] = 0.0
    want = float(JE._pow2_scale(jnp.asarray(x)))
    got = float(TE._pow2_scale(torch.from_numpy(x)))
    assert got == want


DOTS = {
    "matmul": (((1,), (0,)), ((), ())),
    "head": (((1,), (1,)), ((), ())),
    "qk": (((4,), (3,)), ((0, 2), (0, 2))),
    "pv": (((4,), (1,)), ((0, 1), (0, 2))),
}


def _dot_operands(kind, rng):
    if kind == "matmul":
        return rng.normal(size=(6, 40)), rng.normal(size=(40, 24))
    if kind == "head":
        return rng.normal(size=(6, 40)), rng.normal(size=(50, 40))
    if kind == "qk":
        return (rng.normal(size=(2, 3, 2, 2, 8)),
                rng.normal(size=(2, 5, 2, 8)))
    return rng.normal(size=(2, 2, 3, 2, 5)), rng.normal(size=(2, 5, 2, 8))


@pytest.mark.parametrize("mode", ["exact", "posit", "euler", "quant_only"])
@pytest.mark.parametrize("kind", sorted(DOTS))
def test_euler_dot_general_matches(mode, kind, rng):
    a, b = (v.astype(np.float32) for v in _dot_operands(kind, rng))
    jc = JE.from_variant(16, "L-21b", mode=mode)
    tc = TE.from_variant(16, "L-21b", mode=mode)
    want = np.asarray(JE.euler_dot_general(jnp.asarray(a), jnp.asarray(b),
                                           DOTS[kind], jc))
    got = TE.euler_dot_general(torch.from_numpy(a), torch.from_numpy(b),
                               DOTS[kind], tc).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_ste_gradient_is_identity():
    x = torch.randn(4, 8, requires_grad=True)
    w = torch.randn(8, 3)
    cfg = TE.from_variant(16, "L-21b")
    y = TE.euler_dot_general(x, w, DOTS["matmul"], cfg)
    y.sum().backward()
    ref = TE.operand_planes(w, cfg)[0].sum(-1)
    torch.testing.assert_close(x.grad, ref.expand(4, 8))


def test_policy_json_roundtrips_between_packages():
    jpol = (JPol.PrecisionPolicy.uniform(JE.from_variant(16, "L-21b"))
            .with_rule("*attn*", JE.from_variant(8, "L-22b"), op="qk")
            .with_rule("*head*", JE.EulerConfig(mode="exact")))
    text = json.dumps(jpol.to_dict())
    tpol = TPol.PrecisionPolicy.from_dict(json.loads(text))
    assert tpol.to_dict() == json.loads(text)
    for path, op in [("attn", "qk"), ("attn", "pv"), ("mlp", "matmul"),
                     ("head", "matmul")]:
        j, t = jpol.resolve(path, op), tpol.resolve(path, op)
        assert TPol.ecfg_to_dict(t) == JPol.ecfg_to_dict(j)
    back = JPol.PrecisionPolicy.from_dict(json.loads(json.dumps(
        tpol.to_dict())))
    assert back == jpol
