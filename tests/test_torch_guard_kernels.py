"""The guard's fused entries (``kernels/posit_codec.py``:
``posit_quantize_prescaled``, ``posit_sentinels``; ``csrc/
posit_core_codec.cu`` on a card) and the guard functions that call them.

* On the CPU, their plain versions against the JAX package's guard
  (``_quantize_like``, ``sentinel_counts``) bit for bit, NaN as NaN, on
  seeded inputs with zeros, subnormals, Inf, NaN and values past maxpos,
  for P8, P16, P32 and the bounded formats, with and without pre-scale;
  the port's ``_quantize_like`` / ``sentinel_counts`` the same; the
  recorded stats of ``guard_call`` against JAX's on a SMOKE contraction.
* On a card (``cuda`` marker; skips here): each entry bit for bit against
  its plain version given the kernel's ``s``, and ``s`` bit-equal to
  ``posit_encode_prescaled``'s.  This file imports JAX inside a fixture
  only, so it runs on a machine with torch alone:
  ``python -m pytest --noconftest -m cuda tests/test_torch_guard_kernels.py``.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.core import engine as TE
from repro_torch.core import posit as TP
from repro_torch.kernels import _build
from repro_torch.kernels import posit_codec as TPC
from repro_torch.reliability import guards as TG

torch.set_num_threads(1)

# (width, bounded): P8, P16, P32 and the bounded formats of the
# EulerConfig widths
WIDTHS = [(8, False), (8, True), (16, False), (16, True), (32, False),
          (32, True)]
N = 2048


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules (imported here, so the card test runs
    where JAX is missing)."""
    import jax.numpy as jnp
    from repro.core import engine as JE
    from repro.numerics import backends as JB
    from repro.reliability import guards as JG
    return types.SimpleNamespace(jnp=jnp, JE=JE, JB=JB, JG=JG)


def _inputs(seed: int) -> np.ndarray:
    """N seeded values over 2^+-24 (past the maxpos of P8 and the bounded
    formats once scaled) with zeros, subnormals of either sign, Inf and
    NaN."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(N) * np.exp2(rng.integers(-24, 24, N))
    x[rng.random(N) < 0.03] = 0.0
    sub = rng.random(N) < 0.02
    x[sub] = rng.uniform(-1.1e-38, 1.1e-38, sub.sum())
    x[:6] = [np.inf, -np.inf, np.nan, -0.0, 1e-40, 3e38]
    return x.astype(np.float32)


def _same(got, want) -> int:
    """Values that differ in their bits, NaN counted equal to any NaN."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = np.isnan(got) & np.isnan(want)
    return int(((got.view(np.uint32) != want.view(np.uint32)) & ~nan).sum())


def _cfgs(J, width, bounded, pre_scale):
    kw = dict(width=width, bounded=bounded, pre_scale=pre_scale)
    return J.JE.EulerConfig(**kw), TE.EulerConfig(**kw)


def test_the_motivating_guard_case_is_jaxs(J):
    """B-P16 ("euler", the default EulerConfig) on [1e-40, 3e-41, 1, 0.5,
    2, 0]: the check operand is [0, 0, 1, 0.5, 2, 0] and there is no
    sentinel (the port had quantized the three normal values to 5.68e-14
    and counted five saturated words)."""
    x = np.asarray([1e-40, 3e-41, 1.0, 0.5, 2.0, 0.0], np.float32)
    jc, tc = J.JE.EulerConfig(mode="euler"), TE.EulerConfig(mode="euler")
    want = np.asarray(J.JG._quantize_like(J.jnp.asarray(x), jc))
    got = TG._quantize_like(torch.from_numpy(x), tc).numpy()
    assert _same(got, want) == 0
    assert got.tolist() == [0.0, 0.0, 1.0, 0.5, 2.0, 0.0]
    jn, js = J.JG.sentinel_counts(J.jnp.asarray(x), jc)
    assert TG.sentinel_counts(torch.from_numpy(x), tc) == (
        int(jn), int(js)) == (0, 0)


@pytest.mark.parametrize("pre_scale", [True, False], ids=["s", "no_s"])
@pytest.mark.parametrize("width,bounded", WIDTHS,
                         ids=[f"{w}{'b' if b else ''}" for w, b in WIDTHS])
def test_plain_versions_match_jax_guard(J, width, bounded, pre_scale):
    """``quantize_prescaled_plain`` / ``posit_quantize`` (no scale) against
    JAX's ``_quantize_like``, ``sentinels_plain`` against its
    ``sentinel_counts``, and the port's guard functions the same, on a
    finite input (a scale of the whole range) and on one with Inf (its
    scale is Inf: every finite word 0)."""
    jc, tc = _cfgs(J, width, bounded, pre_scale)
    pc = tc.posit
    seen = []
    for x in (_inputs(width)[6:], _inputs(width)):
        xt = torch.from_numpy(x.copy())
        want_q = np.asarray(J.JG._quantize_like(J.jnp.asarray(x), jc))
        if pre_scale:
            q, s = TPC.quantize_prescaled_plain(xt, pc)
            assert float(s) == float(J.JE._pow2_scale(J.jnp.asarray(x)))
        else:
            q = TPC.posit_quantize(xt, pc)
        assert _same(q.numpy(), want_q) == 0
        assert _same(TG._quantize_like(xt, tc).numpy(), want_q) == 0
        jn, js = J.JG.sentinel_counts(J.jnp.asarray(x), jc)
        counts = TPC.sentinels_plain(xt, pc, pre_scale)
        assert counts.dtype == torch.int64 and counts.shape == (2,)
        assert counts.tolist() == [int(jn), int(js)]
        assert TG.sentinel_counts(xt, tc) == (int(jn), int(js))
        seen.append((int(jn), int(js)))
    # the finite input saturates the words past maxpos (P16's and P32's
    # ranges hold all of it); Inf, -Inf and NaN are NaR
    assert seen[0][0] == 0 and (seen[0][1] > 0 or (width > 8
                                                   and not bounded))
    assert seen[1][0] == 3


def test_guard_call_stats_match_jax(J):
    """A SMOKE MLP contraction ([4, 96] x [96, 384]) through ``guard_call``
    on the reference engine, ``record="full"``, at B-P16 L-21b: an
    operand with subnormals, rows at 2^+-12 (saturated output words) and
    a NaN row; every counter equal to the JAX guard's."""
    rng = np.random.default_rng(3)
    a = (rng.standard_normal((4, 96))
         * np.exp2(np.array([[-12.0], [0.0], [12.0], [0.0]]))).astype(
             np.float32)
    a[1, :8] = 1e-40
    a[3, 5] = np.nan
    b = (rng.standard_normal((96, 384)) * 96 ** -0.5).astype(np.float32)
    b[0, :16] = -3e-39
    dn = (((1,), (0,)), ((), ()))
    jc = J.JE.from_variant(16, "L-21b")
    tc = TE.from_variant(16, "L-21b")
    from repro_torch.numerics import backends as TB
    J.JG.reset()
    TG.reset()
    J.JG.guard_call(J.JB.get_backend("lax_ref"), "dot_general",
                    J.jnp.asarray(a), J.jnp.asarray(b), dn, jc,
                    J.JG.GuardConfig(record="full"), op="matmul", path="mlp")
    TG.guard_call(TB.get_backend("lax_ref"), "dot_general",
                  torch.from_numpy(a), torch.from_numpy(b), dn, tc,
                  TG.GuardConfig(record="full"), op="matmul", path="mlp")
    want, got = J.JG.stats(reset=True), TG.stats(reset=True)
    assert got == {k: {c: int(v) for c, v in d.items()}
                   for k, d in want.items()}
    assert got["mlp|matmul"]["saturated_words"] > 0
    assert got["mlp|matmul"]["nar_words"] > 0


def check_guard_kernels_on_card(dev: torch.device) -> None:
    """Each entry bit for bit (NaN as NaN) against its plain version given
    the kernel's s, s bit-equal to ``posit_encode_prescaled``'s, on a
    ragged tensor, a misaligned view and a transposed one read in place,
    for every format, and one launch counted a call (chip_smoke.py phase
    2 holds them at full size)."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.from_numpy(_inputs(1)).to(dev)
    x = torch.cat([x, torch.randn(40001, generator=g, device=dev)
                   * torch.exp2(torch.randint(-30, 30, (40001,), generator=g,
                                              device=dev).float())])
    base = torch.randn(4097, generator=g, device=dev)
    views = {"ragged": x[6:], "with Inf": x, "misaligned": base[1:],
             "transposed": base[1:].reshape(64, 64).t()}

    def same(a, b):
        nan = torch.isnan(a) & torch.isnan(b)
        return bool(((a.view(torch.int32) == b.view(torch.int32))
                     | nan).all())

    for width, bounded in WIDTHS:
        pc = TE.EulerConfig(width=width, bounded=bounded).posit
        for what, v in views.items():
            before = dict(_build.LAUNCHES)
            q, s = TPC.posit_quantize_prescaled(v, pc)
            assert q.shape == v.shape and q.stride() == v.stride(), what
            _, se = TPC.posit_encode_prescaled(v.contiguous(), pc)
            if what != "transposed":      # read in another order there
                assert float(s) == float(se), (what, float(s), float(se))
            want, _ = TPC.quantize_prescaled_plain(v, pc, s)
            assert same(q, want), (pc.name, what)
            for pre in (True, False):
                got = TPC.posit_sentinels(v, pc, pre)
                assert got.device == v.device and got.dtype == torch.int64
                want = TPC.sentinels_plain(v, pc, pre, s if pre else None)
                assert torch.equal(got, want), (pc.name, what, pre)
            assert _build.LAUNCHES["posit_quantize_prescaled"] == \
                before["posit_quantize_prescaled"] + 1
            assert _build.LAUNCHES["posit_sentinels"] == \
                before["posit_sentinels"] + 2
    with pytest.raises(ValueError):
        TPC.posit_quantize_prescaled(x.to(torch.bfloat16), TP.POSIT16)


@pytest.mark.cuda
def test_guard_kernels_match_plain_versions_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    check_guard_kernels_on_card(torch.device("cuda"))
