"""The port's quire oracle and f32 accumulation strategies, the paper's
error metrics and Table I products, the hardware model and the deprecated
``core.reliability`` alias, against the JAX reference.

Bars: the counterparts of ``tests/test_quire.py`` at its own bars;
``np_quire_dot`` equal to the reference's ``Fraction``; ``kahan_sum`` bit
for bit (its scan's operations in its order); ``chunked_sum`` and
``error_metrics`` within rtol 1e-6 (their f32 sums run in torch's order);
``ilm_pair`` on the 45 Table I points bit for bit against eager JAX (under
``jax.jit`` XLA may contract ``va*vb - ra*rb`` into an FMA); every
``hwmodel`` table and result equal.
"""
import warnings
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.core import hwmodel as JH
from repro.core import logmult as JL
from repro.core import metrics as JM
from repro.core import posit as JP
from repro.core import quire as JQ
from repro_torch.core import engine as TE
from repro_torch.core import hwmodel as TH
from repro_torch.core import logmult as TL
from repro_torch.core import metrics as TM
from repro_torch.core import posit as TP
from repro_torch.core import quire as TQ

torch.set_num_threads(1)

# the paper's Table I groups (benchmarks/table1_error.py) and its points:
# the eight ILM variants and the exact-posit baseline R4BM
GROUPS = [(8, "scalar"), (16, "scalar"), (16, "8_16"), (32, "scalar"),
          (32, "8_16_32")]
POINTS = [(w, s, v) for w, s in GROUPS for v in JE.VARIANT_NAMES + ("R4BM",)]


# --------------------------------------------------------------------------
# tests/test_quire.py on the port alone
# --------------------------------------------------------------------------

@pytest.mark.parametrize("K", [64, 512, 4096])
def test_f32_accumulation_close_to_exact_quire(K, rng):
    cfg = TP.POSIT16
    a = rng.normal(size=K).astype(np.float32)
    b = rng.normal(size=K).astype(np.float32)
    pa = TP.encode_from_float(torch.from_numpy(a), cfg)
    pb = TP.encode_from_float(torch.from_numpy(b), cfg)
    exact = TQ.np_quire_dot(pa.numpy(), pb.numpy(), cfg)
    va = TP.decode_to_float(pa, cfg)
    vb = TP.decode_to_float(pb, cfg)
    f32 = float(torch.dot(va, vb))
    kah = float(TQ.kahan_sum(va * vb))
    chk = float(TQ.chunked_sum(va * vb, chunk=256))
    scale = float(abs(exact)) + 1e-3
    for got, tol in ((f32, 1e-4), (kah, 1e-5), (chk, 1e-4)):
        assert abs(got - float(exact)) / scale < tol * np.sqrt(K), (got, exact)


def test_kahan_beats_naive_on_adversarial_sum():
    x = torch.tensor([1e8, 1.0, -1e8, 1.0] * 64, dtype=torch.float32)
    naive = float(torch.cumsum(x, 0)[-1])
    kah = float(TQ.kahan_sum(x))
    assert kah == 128.0  # Neumaier recovers the exact sum
    assert abs(kah - 128.0) <= abs(naive - 128.0)


def test_quire_round_to_nearest():
    cfg = TP.POSIT16
    total = Fraction(3, 7)
    pat = TQ.np_quire_round(total, cfg)
    val = TP.np_decode(pat, cfg)
    assert abs(val - 3 / 7) < 2 ** -12
    assert TP.np_encode(val, cfg) == pat
    for nb in (pat - 1, pat + 1):
        assert abs(TP.np_decode(nb, cfg) - 3 / 7) >= abs(val - 3 / 7)


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("jpc,tpc", [(JP.BPOSIT16, TP.BPOSIT16),
                                     (JP.POSIT8, TP.POSIT8)],
                         ids=["bP16", "P8"])
def test_np_quire_dot_and_round_equal_reference(jpc, tpc, rng):
    pa = rng.integers(0, 1 << jpc.n_bits, 700)
    pb = rng.integers(0, 1 << jpc.n_bits, 700)
    pa[:3] = [0, 1 << (jpc.n_bits - 1), 1]      # zero, NaR (skipped), minpos
    want = JQ.np_quire_dot(pa, pb, jpc)
    got = TQ.np_quire_dot(pa, pb, tpc)
    assert got == want
    assert TQ.np_quire_round(got, tpc) == JQ.np_quire_round(want, jpc)


def _sums(rng):
    adversarial = np.asarray([1e8, 1.0, -1e8, 1.0] * 64, np.float32)
    prods = (rng.standard_normal((5, 1000)) * np.exp2(
        rng.uniform(-20, 20, (5, 1000)))).astype(np.float32)
    return {"adversarial": (adversarial, -1), "products": (prods, -1),
            "axis0": (prods.T.copy(), 0)}


@pytest.mark.parametrize("case", ["adversarial", "products", "axis0"])
def test_kahan_and_chunked_sums_match_reference(case, rng):
    x, axis = _sums(rng)[case]
    want = np.asarray(JQ.kahan_sum(jnp.asarray(x), axis))
    got = TQ.kahan_sum(torch.from_numpy(x), axis).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if case == "adversarial":   # its chunks' sums depend on the f32 order
        return
    want = np.asarray(JQ.chunked_sum(jnp.asarray(x), axis, chunk=256))
    got = TQ.chunked_sum(torch.from_numpy(x), axis, chunk=256).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def table1_operands(n: int, seed: int = 0):
    """``benchmarks/table1_error.py:33-50``'s operand cloud: magnitudes
    2^U(-4, 4), random signs."""
    rng = np.random.default_rng(seed)
    mag = np.exp2(rng.uniform(-4, 4, size=n)).astype(np.float32)
    a = (mag * rng.choice([-1, 1], n)).astype(np.float32)
    b = (np.exp2(rng.uniform(-4, 4, n))
         * rng.choice([-1, 1], n)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("width,simd,variant", POINTS,
                         ids=[f"{w}-{s}-{v}" for w, s, v in POINTS])
def test_table1_point_matches_eager_jax(width, simd, variant):
    """One Table I point at n = 2000: the products bit for bit, then the
    four metrics against the exact posit product (float64 of the quantized
    operands, as the benchmark takes it)."""
    a, b = table1_operands(2000)
    jc = JE.from_variant(width, "L-2" if variant == "R4BM" else variant,
                         simd=simd)
    tc = TE.from_variant(width, "L-2" if variant == "R4BM" else variant,
                         simd=simd)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    qa, qb = TP.quantize(ta, tc.posit), TP.quantize(tb, tc.posit)
    exact = (qa.double() * qb.double()).float()
    with jax.disable_jit():
        jqa = JP.quantize(jnp.asarray(a), jc.posit)
        jqb = JP.quantize(jnp.asarray(b), jc.posit)
        jexact = (np.asarray(jqa).astype(np.float64)
                  * np.asarray(jqb).astype(np.float64)).astype(np.float32)
        if variant == "R4BM":   # the exact-posit multiplier's f32 product
            want, got = jqa * jqb, qa * qb
        else:
            want = JL.ilm_pair(jnp.asarray(a), jnp.asarray(b), jc.posit,
                               jc.stages, jc.trunc, jc.sublane)
            got = TL.ilm_pair(ta, tb, tc.posit, tc.stages, tc.trunc,
                              tc.sublane)
        jm = JM.error_metrics(want, jnp.asarray(jexact))
    np.testing.assert_array_equal(np.asarray(exact), np.asarray(jexact))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))
    tm = TM.error_metrics(got, exact)
    for k in ("mse", "mae", "nmed", "mred"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6,
                                   err_msg=k)


def test_error_metrics_match_reference(rng):
    exact = (rng.standard_normal(5000) * 3).astype(np.float32)
    exact[:20] = 0.0            # excluded from MRED
    approx = (exact * (1 + rng.standard_normal(5000) * 1e-2)
              + rng.standard_normal(5000) * 1e-4).astype(np.float32)
    want = JM.error_metrics(jnp.asarray(approx), jnp.asarray(exact))
    got = TM.error_metrics(torch.from_numpy(approx), torch.from_numpy(exact))
    for k in ("mse", "mae", "nmed", "mred"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)


def test_hwmodel_tables_and_functions_equal_reference():
    for name in ("VARIANTS", "FPGA", "FPGA_PRIOR", "ASIC", "STAGEWISE",
                 "STAGEWISE_PRIOR", "PROTOTYPE", "PROTOTYPE_PRIOR",
                 "_TP_PER_GHZ", "_KNOBS"):
        assert getattr(TH, name) == getattr(JH, name), name
    for w in (8, 16, 32):
        assert TH.throughput_gops(1.72, w) == JH.throughput_gops(1.72, w)
    for v in JH.ASIC:
        assert TH.perf_metrics(v) == JH.perf_metrics(v)
    for col in range(4):
        np.testing.assert_array_equal(TH._fit(col), JH._fit(col))
    for w in (8, 16, 32):
        for v in JH.VARIANTS:
            for simd in (False, True):
                assert (TH.predict_fpga(w, v, simd)
                        == JH.predict_fpga(w, v, simd)), (w, v, simd)
    assert TH.headline_claims() == JH.headline_claims()


def test_core_reliability_alias_warns_and_resolves():
    import importlib

    from repro_torch.core import reliability as R
    ece_mod = importlib.import_module("repro_torch.reliability.ece")
    for name in ("ece", "ece_vs_regime_bound", "improvement_factor",
                 "_classify_bits", "_log2_magnitude"):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            assert getattr(R, name) is getattr(ece_mod, name)
        assert any(issubclass(w.category, DeprecationWarning)
                   for w in caught), name
    with pytest.raises(AttributeError):
        R.no_such_name
