"""The port's pure-Python oracles and the names that complete its core:
``np_decode``/``np_encode``, ``np_ilm_exact``/``np_clear_top_set_bits``,
``ref_decode``/``ref_exact_posit_mac`` and
``euler_matmul``/``euler_einsum_qk``/``euler_einsum_pv``, each against the
JAX reference on the same numpy inputs (``ilm_pair``, the paper's Table I,
is held in ``test_torch_quire_metrics.py`` with the error metrics).

Bars: the oracles and ``ref_decode`` bit for bit; ``ref_exact_posit_mac`` and the engine's wrappers within rtol 1e-5,
atol 1e-4 (``tests/test_kernels.py:72``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.core import logmult as JL
from repro.core import posit as JP
from repro.kernels import ref as JR
from repro_torch.core import engine as TE
from repro_torch.core import logmult as TL
from repro_torch.core import posit as TP
from repro_torch.kernels import ref as TR

torch.set_num_threads(1)

SMALL = [(JP.POSIT8, TP.POSIT8), (JP.BPOSIT8, TP.BPOSIT8),
         (JP.BPOSIT16, TP.BPOSIT16)]
ALL = SMALL + [(JP.POSIT16, TP.POSIT16), (JP.POSIT32, TP.POSIT32),
               (JP.BPOSIT32, TP.BPOSIT32)]

@pytest.mark.parametrize("jpc,tpc", SMALL, ids=[j.name for j, _ in SMALL])
def test_np_decode_every_pattern(jpc, tpc):
    for p in range(1 << jpc.n_bits):
        want, got = JP.np_decode(p, jpc), TP.np_decode(p, tpc)
        assert got == want or (np.isnan(got) and np.isnan(want)), p


def _encode_inputs(pc, rng):
    """About 2,000 values: zero, NaR, minpos/maxpos and beyond, the
    midpoints between neighbouring posits (ties) and a log-uniform cloud."""
    minpos = JP.np_decode(1, pc)
    maxpos = JP.np_decode((1 << (pc.n_bits - 1)) - 1, pc)
    pats = rng.integers(1, 1 << (pc.n_bits - 1), 400)
    lo = np.array([JP.np_decode(int(p), pc) for p in pats])
    hi = np.array([JP.np_decode(int(p) + 1, pc) for p in pats])
    ties = (lo + hi) / 2
    cloud = np.exp2(rng.uniform(-40, 40, 1000)) * rng.choice([-1, 1], 1000)
    special = [0.0, -0.0, np.inf, -np.inf, np.nan, minpos, -minpos, maxpos,
               -maxpos, minpos / 3, maxpos * 3, 1.0, -1.0, 0.5]
    return np.concatenate([special, ties, -ties, lo, cloud]).tolist()


@pytest.mark.parametrize("jpc,tpc", ALL, ids=[j.name for j, _ in ALL])
def test_np_encode_equals_reference(jpc, tpc, rng):
    for x in _encode_inputs(jpc, rng):
        assert TP.np_encode(x, tpc) == JP.np_encode(x, jpc), x


def test_np_ilm_exact_and_clear_top_set_bits(rng):
    for A, B in rng.integers(0, 1 << 24, (500, 2)):
        for n in (1, 2, 3, 6, 12):
            assert TL.np_ilm_exact(A, B, n) == JL.np_ilm_exact(A, B, n)
    for x in rng.integers(0, 1 << 40, 500):
        for k in (0, 1, 3, 8):
            assert (TL.np_clear_top_set_bits(x, k)
                    == JL.np_clear_top_set_bits(x, k))


def _words(pc, shape, rng):
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    return x, JP.encode_from_float(jnp.asarray(x), pc)


@pytest.mark.parametrize("jpc,tpc", ALL, ids=[j.name for j, _ in ALL])
def test_ref_decode_and_exact_posit_mac(jpc, tpc, rng):
    _, wa = _words(jpc, (12, 12), rng)
    _, wb = _words(jpc, (12, 12), rng)
    wa = wa.at[0, 0].set(1 << (jpc.n_bits - 1))   # a NaR word
    ta = torch.from_numpy(np.asarray(wa).astype(np.int64))
    tb = torch.from_numpy(np.asarray(wb).astype(np.int64))
    want = np.asarray(JR.ref_decode(wa, jpc))
    got = TR.ref_decode(ta, tpc).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.nan_to_num(got).view(np.uint32),
                                  np.nan_to_num(want).view(np.uint32))
    want = np.asarray(JR.ref_exact_posit_mac(wa, wb, jpc))
    got = TR.ref_exact_posit_mac(ta, tb, tpc).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert np.isnan(got[0]).all()


# one operand shape for every wrapper and the decode test, [12, 12]
# (T = S = D = 12; qk and pv with a batch of heads in front too): eager
# JAX compiles each primitive once per shape
WRAPPERS = {
    "matmul": (JE.euler_matmul, TE.euler_matmul, [(12, 12), (12, 12)]),
    "qk": (JE.euler_einsum_qk, TE.euler_einsum_qk, [(12, 12), (12, 12)]),
    "pv": (JE.euler_einsum_pv, TE.euler_einsum_pv, [(12, 12), (12, 12)]),
    "qk_heads": (JE.euler_einsum_qk, TE.euler_einsum_qk,
                 [(1, 12, 12), (1, 12, 12)]),
}


@pytest.mark.parametrize("width", [8, 16, 32])
@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_engine_wrappers_match_reference(name, width, rng):
    jf, tf, shapes = WRAPPERS[name]
    a, b = (rng.standard_normal(s).astype(np.float32) for s in shapes)
    want = np.asarray(jf(jnp.asarray(a), jnp.asarray(b),
                         JE.from_variant(width, "L-21b")))
    got = tf(torch.from_numpy(a), torch.from_numpy(b),
             TE.from_variant(width, "L-21b")).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
