"""XLA's subnormal flush in the port's pre-scale and codec, against the JAX
package on the CPU.

XLA flushes f32 and bf16 subnormals to zero, on its CPU runtime as on a
TPU: the reference's ``_pow2_scale`` tests ``|x| > 0`` under that flush,
so a subnormal does not count; its pre-scale ``x / s`` reads a subnormal
``x`` as 0; its encode gives a subnormal the word 0.  The port follows the
rule in ``engine._pow2_scale`` (plain and over a process group),
``posit_codec.encode_prescaled_plain``, the engine's operand planes,
paged decode's q and logfxp's statistics.  Every tensor here holds 0.1-10
% subnormal values, and one case is placed so that counting the
subnormals would move the scale.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.core import logmult as JLM
from repro.core import posit as JP
from repro.kernels import posit_codec as JPC
from repro_torch.core import engine as TE
from repro_torch.core import logmult as TLM
from repro_torch.core import posit as TP
from repro_torch.kernels import paged_decode as TPD
from repro_torch.kernels import posit_codec as TPC
from torch_ranks import spawn, subnormal_stats_rank

torch.set_num_threads(1)

TINY = 2.0 ** -126
SHARES = [0.001, 0.01, 0.1]
N = 4096          # one shape across the file: eager JAX compiles per shape


def _with_subnormals(share: float, seed: int, spread: int = 8,
                     centre: float = -6.0) -> np.ndarray:
    """N seeded normals at magnitudes 2^(centre +- spread), zeros, and a
    ``share`` of them replaced by subnormals of either sign."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(N) * np.exp2(
        centre + rng.integers(-spread, spread, N))
    x[rng.random(N) < 0.02] = 0.0
    sub = rng.random(N) < share
    x[sub] = (rng.uniform(1.4e-45, TINY, sub.sum())
              * rng.choice([-1.0, 1.0], sub.sum()))
    x = x.astype(np.float32)
    assert ((x != 0) & (np.abs(x) < TINY)).any()
    return x


def _counted_scale(x: np.ndarray) -> float:
    """The scale a pre-scale that counted subnormals (``|x| > 0`` without
    the flush) would give."""
    ax = np.abs(x.astype(np.float64))
    return float(2.0 ** np.rint(np.log2(ax[ax > 0]).mean()))


def test_the_motivating_scales_are_jaxs():
    """Six subnormals beside 1 and 2: JAX's scale is 1 (the port counted
    them to 2.52e-29); three beside 4: JAX's is 4 (the port had 5.05e-29).
    """
    for vals, want in (([1e-40] * 6 + [1.0, 2.0], 1.0),
                       ([1e-40] * 3 + [4.0], 4.0)):
        x = np.asarray(vals, np.float32)
        assert float(JE._pow2_scale(jnp.asarray(x))) == want
        assert float(TE._pow2_scale(torch.from_numpy(x))) == want


@pytest.mark.parametrize("share", SHARES)
def test_pow2_scale_matches_jax(share):
    x = _with_subnormals(share, seed=int(share * 1000))
    want = float(JE._pow2_scale(jnp.asarray(x)))
    assert float(TE._pow2_scale(torch.from_numpy(x))) == want
    # bf16 operands: the scale of their f32 values
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = float(JE._pow2_scale(jnp.asarray(xb.float().numpy()).astype(
        jnp.bfloat16)))
    assert float(TE._pow2_scale(xb)) == wb


def test_a_subnormal_share_that_moves_the_scale():
    """1 % subnormals among values near 2^-2: counting them at about
    log2 = -130 would move the mean by more than 1; JAX's scale ignores
    them, and so does the port's."""
    x = _with_subnormals(0.01, seed=5, spread=2, centre=-2.0)
    want = float(JE._pow2_scale(jnp.asarray(x)))
    assert _counted_scale(x) <= want / 2
    assert float(TE._pow2_scale(torch.from_numpy(x))) == want
    for jpc, tpc in ((JP.BPOSIT16, TP.BPOSIT16), (JP.POSIT8, TP.POSIT8)):
        words, s = TPC.encode_prescaled_plain(torch.from_numpy(x), tpc)
        assert float(s) == want
        jw = np.asarray(JPC.posit_encode(jnp.asarray(x) / jnp.float32(want),
                                         jpc, block=N, interpret=True))
        np.testing.assert_array_equal(words.numpy().view(np.uint32), jw)


@pytest.mark.parametrize("share", SHARES)
@pytest.mark.parametrize("fmt", [(8, 0, None), (16, 1, 3), (32, 2, None)],
                         ids=str)
def test_encode_prescaled_plain_matches_jax(fmt, share):
    """Scale and words of ``encode_prescaled_plain`` against JAX's
    ``_pow2_scale`` and interpret-mode ``posit_encode(x / s)``: with the
    mean magnitude near 2^-10 the scale is below 1, so a subnormal x / s
    would be a normal value had XLA not read x as 0 (and the word minpos
    where XLA gives 0).  The mean log2 stays inside +-12: beyond it
    XLA:CPU's exp2 is not exact (ROADMAP queue 3)."""
    x = _with_subnormals(share, seed=7, spread=2, centre=-10.0)
    js = JE._pow2_scale(jnp.asarray(x))
    assert 2.0 ** -12 <= float(js) < 2.0 ** -6
    want = np.asarray(JPC.posit_encode(jnp.asarray(x) / js,
                                       JP.PositConfig(*fmt), block=N,
                                       interpret=True))
    words, s = TPC.encode_prescaled_plain(torch.from_numpy(x),
                                          TP.PositConfig(*fmt))
    assert float(s) == float(js)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)


@pytest.mark.parametrize("mode", ["posit", "euler"])
def test_operand_planes_match_jax(mode):
    """The engine's operand planes (the reference engine's pre-scale, the
    quotient and, in posit mode, the product ``q * s``) on an operand with
    subnormals and a scale below 1."""
    x = _with_subnormals(0.01, seed=9, spread=2, centre=-10.0)
    jc = JE.from_variant(16, "L-21b", mode=mode)
    tc = TE.from_variant(16, "L-21b", mode=mode)
    jv, jr = JE.operand_planes(jnp.asarray(x), jc)
    tv, tr = TE.operand_planes(torch.from_numpy(x), tc)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if mode == "euler":
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_paged_decode_q_setup_matches_jax():
    """Paged decode's q: its pow2 scale over the whole batch and the words
    of q / sq against the JAX kernel's set-up (``encode_body(qf / sq)``)."""
    B, KV, G, hd = 4, 2, 2, 256
    x = _with_subnormals(0.01, seed=11, spread=2, centre=-10.0)
    q = x.reshape(B, 1, KV * G, hd)
    cfg = TE.from_variant(16, "L-21b")
    kp = torch.zeros((3, 16, KV, hd), dtype=torch.int16)
    qs, scl = TPD._q_setup(torch.from_numpy(q), kp, cfg)
    qf = jnp.asarray(q[:, 0].reshape(B, KV, G, hd))
    sq = JE._pow2_scale(qf)
    want = np.asarray(JPC.encode_body(qf / sq, JP.BPOSIT16))
    assert cfg.posit == TP.BPOSIT16
    got = TPC.encode_plain(qs, cfg.posit).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    assert float(scl[0]) == float(sq * hd ** -0.5)


@pytest.mark.parametrize("share", SHARES)
def test_logfxp_statistics_match_jax(share):
    """logfxp's per-tensor max and its codes: a subnormal cannot be the max
    of a tensor that holds a normal value, and the scale keeps it below a
    code's half step, so nothing moves; held all the same."""
    x = _with_subnormals(share, seed=13, spread=3, centre=2.0)
    for bits in (8, 16):
        jq, jcodes, jscale = JLM.fxp_quantize(jnp.asarray(x), bits)
        tq, tcodes, tscale = TLM.fxp_quantize(torch.from_numpy(x), bits)
        assert float(tscale) == float(jscale)
        np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


def test_group_statistics_skip_subnormals(tmp_path):
    """Two gloo ranks, each holding half the rows of a tensor with
    subnormals: the group's scale and words are JAX's on the whole
    tensor (``_pow2_scale(x, group)``, the split encode's plain version),
    and logfxp's group max its max."""
    x = _with_subnormals(0.01, seed=5, spread=2, centre=-2.0).reshape(2, -1)
    want = float(JE._pow2_scale(jnp.asarray(x)))
    assert _counted_scale(x) != want
    jw = np.asarray(JPC.posit_encode(
        jnp.asarray(x.reshape(-1)) / jnp.float32(want), JP.BPOSIT16,
        block=N, interpret=True)).reshape(x.shape)
    fe = int(TLM.fxp_frac_exp(torch.from_numpy(x), 8))
    got = spawn(subnormal_stats_rank, 2, tmp_path / "ranks", x)
    for r, g in enumerate(got):
        assert float(g["scale"]) == want
        assert float(g["words_scale"]) == want
        np.testing.assert_array_equal(g["words"].numpy().view(np.uint32),
                                      jw[r:r + 1])
        assert int(g["frac_exp"]) == fe
