"""The log-fixed-point baseline (paper Table VI "Log-fxp_n", engine mode
``logfxp``) and the engine's chunked plane construction.

Bars, stated before the first run:
  * ``fxp_quantize`` / ``logfxp_planes``: bit-exact against a float64 numpy
    oracle of their definition at every scale; bit-exact against JAX where
    |frac_exp| <= 12.  Above that ``jnp.exp2`` on XLA:CPU is inexact
    (ROADMAP queue 3): the test states the gap it measures there (JAX's
    scale within 1e-5 relative of the exact power of two, its planes
    within 2^-13 of the tensor's max magnitude, plus that relative error);
  * a logfxp dot on both backends within rtol 1e-4 / atol 2e-3 of JAX's
    (``lax_ref``, and ``cuda`` as ``pallas``, send logfxp to the
    reference engine);
  * the guard's logfxp tolerance equal to the reference's;
  * planes built a slice of the leading dimension at a time bit-identical
    to one whole-tensor pass, values and gradients, in every mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.core import logmult as JLM
from repro.numerics import NumericsContext as JN
from repro.numerics import backends as JB
from repro.reliability import guards as JG
from repro_torch.core import engine as TE
from repro_torch.core import logmult as TLM
from repro_torch.numerics import NumericsContext as TN
from repro_torch.numerics import backends as TB
from repro_torch.reliability import guards as TG

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=2e-3)


def _oracle(x: np.ndarray, bits: int, n: int):
    """fxp_quantize + logfxp_planes from their definition in float64:
    (frac_exp, dequantized, val, rem), the exact powers of two."""
    amax = np.float32(np.max(np.abs(x))) + np.float32(1e-30)
    frac_exp = (bits - 2) - int(np.ceil(np.log2(np.float64(amax))))
    scale = 2.0 ** frac_exp
    lim = 2 ** (bits - 1) - 1
    q = np.clip(np.round(x.astype(np.float64) * scale), -lim, lim)
    mag = np.abs(q).astype(np.int64)
    rem_mag = mag.copy()
    for _ in range(n):
        top = np.where(rem_mag > 0,
                       np.floor(np.log2(np.maximum(rem_mag, 1))), 0
                       ).astype(np.int64)
        rem_mag = np.where(rem_mag > 0, rem_mag - (1 << top), 0)
    sgn = np.sign(q)
    return (frac_exp, (q / scale).astype(np.float32),
            (sgn * mag / scale).astype(np.float32),
            (sgn * rem_mag / scale).astype(np.float32))


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


SCALES = list(range(-24, 25, 4)) + [-11, -10, 11, 12, 13, 14, 15]


@pytest.mark.parametrize("bits,n", [(8, 2), (8, 3), (16, 4), (16, 6),
                                    (32, 12)])
def test_logfxp_planes_exact_at_every_scale(bits, n):
    """The port against the float64 oracle at every scale, and against JAX
    bit for bit where |frac_exp| <= 12; above, JAX's gap as stated."""
    rng = np.random.default_rng(bits * 10 + n)
    base = rng.standard_normal((64, 48)).astype(np.float32)
    base[0, :4] = [0.0, -0.0, 1e-30, -1e-30]
    beyond = 0
    for e in SCALES:
        x = (base * np.float32(2.0 ** e)).astype(np.float32)
        frac_exp, deq, val, rem = _oracle(x, bits, n)
        t_deq, t_q, t_scale = TLM.fxp_quantize(torch.from_numpy(x), bits)
        t_val, t_rem = TLM.logfxp_planes(torch.from_numpy(x), bits, n)
        assert int(TLM.fxp_frac_exp(torch.from_numpy(x), bits)) == frac_exp
        assert float(t_scale) == 2.0 ** frac_exp
        np.testing.assert_array_equal(t_deq.numpy(), deq)
        np.testing.assert_array_equal(np.abs(t_val.numpy()), np.abs(val))
        np.testing.assert_array_equal(np.abs(t_rem.numpy()), np.abs(rem))
        assert (np.sign(t_val.numpy()) == np.sign(val)).all()
        j_deq, j_q, j_scale = JLM.fxp_quantize(jnp.asarray(x), bits)
        j_val, j_rem = JLM.logfxp_planes(jnp.asarray(x), bits, n)
        if abs(frac_exp) <= 12:
            assert float(j_scale) == float(t_scale)
            np.testing.assert_array_equal(t_q.numpy(), np.asarray(j_q))
            for got, want in ((t_deq, j_deq), (t_val, j_val),
                              (t_rem, j_rem)):
                np.testing.assert_array_equal(_bits(got.numpy()),
                                              _bits(want))
        else:
            beyond += 1
            rel = abs(float(j_scale) / 2.0 ** frac_exp - 1.0)
            assert rel <= 1e-5, (e, frac_exp, rel)
            amax = float(np.max(np.abs(x)))
            gap = float(np.max(np.abs(np.asarray(j_val) - t_val.numpy())))
            assert gap <= amax * (2.0 ** -13 + 1e-5), (e, frac_exp, gap)
    assert beyond > 0          # the exp2 gap is exercised, not avoided


@pytest.mark.parametrize("fixed", [3, -5, 20])
def test_fxp_quantize_with_fixed_frac_bits(fixed):
    x = torch.from_numpy(np.random.default_rng(fixed + 9).standard_normal(
        (8, 8)).astype(np.float32))
    deq, q, scale = TLM.fxp_quantize(x, 16, fixed)
    assert float(scale) == 2.0 ** fixed
    torch.testing.assert_close(deq, q.to(torch.float32) / scale, rtol=0,
                               atol=0)
    assert int(q.abs().max()) <= 2 ** 15 - 1


@pytest.mark.parametrize("width,stages", [(8, 2), (16, 3), (16, 6)])
@pytest.mark.parametrize("tbackend,jbackend", [("lax_ref", "lax_ref"),
                                               ("cuda", "pallas")])
def test_logfxp_dot_matches_reference(width, stages, tbackend, jbackend):
    """A logfxp dot on each backend: the reference engine on both sides
    (``lax_ref``, and ``cuda``/``pallas``, which route every mode but euler
    there), within the logits bar of JAX's; close to the exact product."""
    rng = np.random.default_rng(width + stages)
    a = rng.standard_normal((6, 40)).astype(np.float32)
    b = (rng.standard_normal((40, 24)) * 0.2).astype(np.float32)
    dn = (((1,), (0,)), ((), ()))
    jcfg = JE.EulerConfig(width=width, mode="logfxp", stages=stages)
    tcfg = TE.EulerConfig(width=width, mode="logfxp", stages=stages)
    want = JB.get_backend(jbackend).dot_general(jnp.asarray(a),
                                                jnp.asarray(b), dn, jcfg)
    got = TB.get_backend(tbackend).dot_general(torch.from_numpy(a),
                                               torch.from_numpy(b), dn, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    exact = a @ b
    rel = np.linalg.norm(got.numpy() - exact) / np.linalg.norm(exact)
    assert rel < 0.1
    # the reference's round trip of the config through a policy
    nctx = TN.from_ecfg(tcfg, backend=tbackend)
    assert nctx.policy.default.mode == "logfxp"
    assert JN.from_ecfg(jcfg).policy.default.mode == "logfxp"


def test_logfxp_planes_stop_gradient_on_rem():
    """STE: the value plane passes the gradient as the identity, the rem
    plane carries none."""
    x = torch.randn(5, 7, requires_grad=True)
    cfg = TE.EulerConfig(width=16, mode="logfxp", stages=3)
    val, rem = TE.operand_planes(x, cfg)
    assert not rem.requires_grad
    (g,) = torch.autograd.grad(val.sum(), x)
    torch.testing.assert_close(g, torch.ones_like(x), rtol=0, atol=0)


@pytest.mark.parametrize("stages", [2, 3, 6])
def test_guard_tolerance_for_logfxp_matches_reference(stages):
    for width in (8, 16, 32):
        tcfg = TE.EulerConfig(width=width, mode="logfxp", stages=stages)
        jcfg = JE.EulerConfig(width=width, mode="logfxp", stages=stages)
        assert TG.check_eps(tcfg) == JG.check_eps(jcfg)
        assert TG.quant_eps(tcfg) == JG.quant_eps(jcfg)
        assert TG.check_eps(tcfg) == 2.0 ** -(2 * stages + 2)


CHUNK_CFGS = {
    "euler": TE.from_variant(16, "L-21b"),
    "euler-p8-no-prescale": TE.from_variant(8, "L-2b", pre_scale=False),
    "posit": TE.from_variant(16, "L-21b", mode="posit"),
    "quant_only": TE.from_variant(32, "L-22b", mode="quant_only"),
    "logfxp": TE.EulerConfig(width=16, mode="logfxp", stages=4),
}


@pytest.mark.parametrize("name", sorted(CHUNK_CFGS))
@pytest.mark.parametrize("shape,chunk", [((7, 40, 30), 1000),
                                         ((9, 33), 64),
                                         ((5, 3, 4, 11), 1)])
def test_chunked_planes_bit_identical(monkeypatch, name, shape, chunk):
    """Planes of a tensor spanning many chunks (a slice of its leading
    dimension at a time, one row per slice at chunk 1) equal one
    whole-tensor pass bit for bit, and so do the gradients through the
    value plane; the per-tensor statistics come from the whole tensor."""
    cfg = CHUNK_CFGS[name]
    g = torch.Generator().manual_seed(len(shape) * 100 + chunk)
    x0 = torch.randn(shape, generator=g) * torch.exp2(torch.randint(
        -6, 7, shape, generator=g).float())
    x0.view(-1)[:3] = torch.tensor([0.0, -0.0, 1e-30])
    whole_n = x0.numel() + 1
    ct = torch.randn(shape, generator=g)
    outs = []
    for c in (whole_n, chunk):
        monkeypatch.setattr(TE, "PLANE_CHUNK", c)
        x = x0.clone().requires_grad_(True)
        val, rem = TE.operand_planes(x, cfg)
        (gx,) = torch.autograd.grad((val * ct).sum(), x)
        outs.append((val.detach(), rem, gx))
    (v1, r1, g1), (v2, r2, g2) = outs
    assert torch.equal(v1.view(torch.int32), v2.view(torch.int32))
    assert (r1 is None) == (r2 is None)
    if r1 is not None:
        assert torch.equal(r1.view(torch.int32), r2.view(torch.int32))
    assert torch.equal(g1.view(torch.int32), g2.view(torch.int32))


def test_chunked_planes_by_default_above_plane_chunk(monkeypatch):
    """``operand_planes`` slices by itself above ``PLANE_CHUNK`` values (an
    expert weight [E, d, f]); a dot through it equals the whole pass."""
    cfg = TE.from_variant(16, "L-21b")
    g = torch.Generator().manual_seed(5)
    w = torch.randn((4, 32, 24), generator=g) * 32 ** -0.5
    a = torch.randn((4, 3, 32), generator=g)
    dnb = (((2,), (1,)), ((0,), (0,)))
    want = TE.euler_dot_general(a, w, dnb, cfg)
    calls = []
    inner = TE.LM.ilm_planes_from_float

    def spy(x, *args, **kw):
        calls.append(tuple(x.shape))
        return inner(x, *args, **kw)

    monkeypatch.setattr(TE, "PLANE_CHUNK", 32 * 24)
    monkeypatch.setattr(TE.LM, "ilm_planes_from_float", spy)
    got = TE.euler_dot_general(a, w, dnb, cfg)
    assert calls.count((1, 32, 24)) == 4      # w: one expert per slice
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _exp2_gap_table():
    """Beyond |frac_exp| 12, per width: JAX's largest relative scale error,
    its codes that differ from the port's, and its value plane's largest
    distance from the port's relative to |x|max, over 2^16 randn values at
    the scales 2^-40 .. 2^40 (ROADMAP queue 3)."""
    base = np.random.default_rng(0).standard_normal((256, 256)).astype(
        np.float32)
    for bits in (8, 16, 32):
        rel = gap = 0.0
        n_diff = n_all = 0
        exps = []
        for e in range(-40, 41):
            x = base * np.float32(2.0 ** e)
            fe = int(TLM.fxp_frac_exp(torch.from_numpy(x), bits))
            if abs(fe) <= 12:
                continue
            exps.append(fe)
            _, jq, js = JLM.fxp_quantize(jnp.asarray(x), bits)
            _, tq, ts = TLM.fxp_quantize(torch.from_numpy(x), bits)
            jv, _ = JLM.logfxp_planes(jnp.asarray(x), bits, 4)
            tv, _ = TLM.logfxp_planes(torch.from_numpy(x), bits, 4)
            rel = max(rel, abs(float(js) / float(ts) - 1.0))
            gap = max(gap, float(np.max(np.abs(np.asarray(jv) - tv.numpy())))
                      / float(np.max(np.abs(x))))
            n_diff += int((np.asarray(jq) != tq.numpy()).sum())
            n_all += x.size
        print(f"width {bits}: frac_exp {min(exps)}..{max(exps)} beyond 12; "
              f"JAX's scale off by <= {rel:.3e} relative; {n_diff} of "
              f"{n_all} codes differ; value planes within {gap:.3e} x "
              f"|x|max")


if __name__ == "__main__":
    _exp2_gap_table()
