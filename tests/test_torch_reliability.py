"""The port's reliability tier against the JAX reference: bit-role masks,
ECE, the deterministic half of fault injection, the ABFT guard functions,
and the guarded SMOKE model.  Inputs come from numpy and go through both
packages; every bar is the JAX suite's bar for the same function."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma2_2b as JG
from repro.core import posit as JP
from repro.core.engine import EulerConfig as JEC
from repro.core.engine import from_variant as j_variant
from repro.models.layers import Ctx as JCtx
from repro.models.transformer import Model as JModel
from repro.numerics import NumericsContext as JN
from repro.reliability import faults as JF
from repro.reliability import guards as JGd
from repro_torch.configs import gemma2_2b as TG
from repro_torch.core import posit as TP
from repro_torch.core.engine import EulerConfig as TEC
from repro_torch.core.engine import from_variant as t_variant
from repro_torch.models.layers import Ctx as TCtx
from repro_torch.models.transformer import Model as TModel, params_from_jax
from repro_torch.numerics import NumericsContext as TN
from repro_torch.numerics import api as TApi
from repro_torch.numerics.backends import get_backend, guarded
from repro_torch.reliability import faults as TF
from repro_torch.reliability import guards as TGd

# the packages re-export their ``ece`` function under the module's name
JE = importlib.import_module("repro.reliability.ece")
TE = importlib.import_module("repro_torch.reliability.ece")

torch.set_num_threads(1)

FMT16 = [(JP.POSIT8, TP.POSIT8), (JP.BPOSIT8, TP.BPOSIT8),
         (JP.POSIT16, TP.POSIT16), (JP.BPOSIT16, TP.BPOSIT16)]
IDS16 = [j.name for j, _ in FMT16]


def _all(jpc) -> np.ndarray:
    return np.arange(1 << jpc.n_bits, dtype=np.uint32)


def _t(w: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(w.astype(np.int64))


# ---------------------------------------------------------------------------
# bit roles, ECE and the deterministic half of fault injection (bit-exact)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jpc,tpc", FMT16, ids=IDS16)
def test_role_masks_match_exhaustively(jpc, tpc):
    w = _all(jpc)
    for role in TF.ROLES:
        want = np.asarray(JF.role_mask(jnp.asarray(w), jpc, role))
        got = TF.role_mask(_t(w), tpc, role).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64),
                                      err_msg=role)


@pytest.mark.parametrize("jpc,tpc", FMT16, ids=IDS16)
def test_classify_bits_and_word_flags_match_exhaustively(jpc, tpc):
    w = _all(jpc)
    want, _ = JE._classify_bits(jnp.asarray(w), jpc)
    got, _ = TE._classify_bits(_t(w), tpc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jflags = JE.word_flags(jnp.asarray(w), jpc)
    tflags = TE.word_flags(_t(w), tpc)
    for k in ("is_nar", "is_zero", "saturated"):
        np.testing.assert_array_equal(tflags[k].numpy(),
                                      np.asarray(jflags[k]), err_msg=k)


@pytest.mark.parametrize("jpc,tpc", FMT16, ids=IDS16)
def test_ece_per_role_matches(jpc, tpc):
    """Exact enumeration at widths 8 and 16: every eta within 1e-6."""
    want, got = JE.ece(jpc), TE.ece(tpc)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_improvement_factor_and_regime_bound_sweep_match():
    """Eq. 7's Gamma_B > 1 and Eq. 6's monotone eta(R), as the reference
    computes them, at width 8 (exact enumeration)."""
    np.testing.assert_allclose(TE.improvement_factor(8),
                               JE.improvement_factor(8), rtol=1e-6)
    assert TE.improvement_factor(8) > 1.0
    got = TE.ece_vs_regime_bound(8, (1, 2, 3, 4))
    want = JE.ece_vs_regime_bound(8, (1, 2, 3, 4))
    np.testing.assert_allclose(list(got.values()), list(want.values()),
                               rtol=0, atol=1e-6)
    assert list(got.values()) == sorted(got.values())


def test_nth_set_bit_matches(rng):
    mask = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    r = rng.integers(0, 40, 4096).astype(np.int32)
    want = np.asarray(JF._nth_set_bit(jnp.asarray(mask), jnp.asarray(r)))
    got = TF._nth_set_bit(_t(mask), torch.from_numpy(r.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    pop = np.asarray(jax.lax.population_count(jnp.asarray(mask)))
    np.testing.assert_array_equal(TF.popcount(_t(mask)).numpy(), pop)


def _jax_flips(w, jpc, role, sel, r):
    """The reference's flip_words with its random draws replaced by the
    given (sel, r): the same ops as ``repro.reliability.faults:270-282``."""
    pats = jnp.asarray(w)
    mask = JF.role_mask(pats, jpc, role)
    pop = jax.lax.population_count(mask).astype(jnp.int32)
    f0 = JP.decode_fields(pats, jpc)
    s = jnp.asarray(sel) & (pop > 0)
    s = s & ~(f0["is_zero"] | f0["is_nar"])
    onehot = JF._nth_set_bit(mask, jnp.asarray(r) % jnp.maximum(pop, 1))
    flips = jnp.where(s, onehot, jnp.uint32(0))
    return np.asarray(pats ^ flips), np.asarray(s & (flips != 0))


@pytest.mark.parametrize("role", TF.ROLES)
@pytest.mark.parametrize("jpc,tpc", [(JP.BPOSIT16, TP.BPOSIT16),
                                     (JP.POSIT32, TP.POSIT32)],
                         ids=["bposit16", "posit32"])
def test_flip_words_at_given_positions_match(jpc, tpc, role, rng):
    w = rng.integers(0, 1 << jpc.n_bits, 2048,
                     dtype=np.uint64).astype(np.uint32)
    w[:2] = [0, 1 << (jpc.n_bits - 1)]
    sel = rng.random(2048) < 0.5
    sel[:2] = True
    r = rng.integers(0, 1 << 30, 2048).astype(np.int32)
    want, want_hit = _jax_flips(w, jpc, role, sel, r)
    got, hit = TF.apply_flips(_t(w), tpc, role, torch.from_numpy(sel),
                              torch.from_numpy(r.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(hit.numpy(), want_hit)
    assert not hit[:2].any()  # zero and NaR are never flipped


def test_fault_plan_json_round_trips_across_packages():
    plans = [JF.FaultPlan(), JF.FaultPlan(seed=3, rate=0.25,
                                          role="regime_run", path="*mlp*",
                                          op="matmul", operand="both",
                                          start_step=2, end_step=9,
                                          record=True)]
    for jp in plans:
        tp = TF.FaultPlan.from_json(jp.to_json())
        assert tp.to_json() == jp.to_json()
        assert JF.FaultPlan.from_json(tp.to_json()) == jp
    with pytest.raises(ValueError):
        TF.FaultPlan(start_step=3, end_step=3)
    with pytest.raises(ValueError):
        TF.FaultPlan(role="mantissa")
    assert TF.call_salt("attn", "qk", "a") == JF.call_salt("attn", "qk", "a")


def test_flip_words_rate_window_and_retry_redraw():
    """Within the port (the JAX PRNG stream cannot be reproduced): the
    empirical flip rate, the step window, and a fresh draw on a retry."""
    pc = TP.BPOSIT16
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(64, 512)).astype(np.float32))
    cfg = TEC(width=16)
    plan = TF.FaultPlan(seed=4, rate=0.05, role="fraction", end_step=5)
    pats = TP.encode_from_float(x, pc)
    flipped, hit = TF.flip_words(pats, pc, plan, key=123)
    assert abs(float(hit.float().mean()) - 0.05) < 0.01
    assert int(((flipped ^ pats) != 0).sum()) == int(hit.sum())
    again, _ = TF.flip_words(pats, pc, plan, key=123)
    assert torch.equal(again, flipped)           # deterministic for a key
    assert torch.equal(TF.corrupt(x, cfg, plan, 7, step=5), x)  # past window
    a = TF.corrupt(x, cfg, plan, 7, step=1)
    with TF.retrying(1):
        b = TF.corrupt(x, cfg, plan, 7, step=1)
    assert not torch.equal(a, b) and not torch.equal(a, x)


# ---------------------------------------------------------------------------
# ABFT guard functions on the same operands
# ---------------------------------------------------------------------------

CFGS = [("exact", {}), ("posit", {"width": 16}), ("posit", {"width": 8}),
        ("euler", {"width": 16}), ("euler", {"width": 32, "trunc": None}),
        ("quant_only", {"width": 16, "out_quant": True})]


@pytest.mark.parametrize("mode,kw", CFGS, ids=[m for m, _ in CFGS])
def test_guard_calibration_and_ladder_match(mode, kw):
    jc, tc = JEC(mode=mode, **kw), TEC(mode=mode, **kw)
    assert TGd.check_eps(tc) == JGd.check_eps(jc)
    assert TGd.quant_eps(tc) == JGd.quant_eps(jc)
    for gk in ({}, {"max_retries": 2}, {"max_retries": 0},
               {"retry_same": False}):
        want = JGd.escalation_ladder(jc, JGd.GuardConfig(**gk))
        got = TGd.escalation_ladder(tc, TGd.GuardConfig(**gk))
        assert [(c.mode, c.width, c.bounded, c.stages, c.trunc)
                for c in got] == [(c.mode, c.width, c.bounded, c.stages,
                                   c.trunc) for c in want]
    for w in (8, 16, 32):
        v = j_variant(w, "L-21b")
        assert [c.variant for c in TGd.escalation_ladder(
            t_variant(w, "L-21b"))] == [
                c.variant for c in JGd.escalation_ladder(v)]


DNS = {"matmul": ((6, 40), (40, 24), (((1,), (0,)), ((), ()))),
       "qk": ((2, 3, 5, 16), (2, 3, 7, 16), (((3,), (3,)), ((0, 1), (0, 1)))),
       "pv": ((2, 3, 5, 7), (2, 3, 7, 16), (((3,), (2,)), ((0, 1), (0, 1))))}


@pytest.mark.parametrize("kind", list(DNS))
def test_abft_residual_and_violation_match(kind, rng):
    sa, sb, dn = DNS[kind]
    a = rng.normal(size=sa).astype(np.float32)
    b = rng.normal(size=sb).astype(np.float32)
    for mode in ("posit", "euler"):
        jc, tc = j_variant(16, "L-21b", mode=mode), t_variant(
            16, "L-21b", mode=mode)
        aq_j = np.asarray(JGd._quantize_like(jnp.asarray(a), jc))
        bq_j = np.asarray(JGd._quantize_like(jnp.asarray(b), jc))
        aq_t = TGd._quantize_like(torch.from_numpy(a), tc)
        bq_t = TGd._quantize_like(torch.from_numpy(b), tc)
        np.testing.assert_array_equal(aq_t.numpy(), aq_j)
        np.testing.assert_array_equal(bq_t.numpy(), bq_j)
        out = np.array(jax.lax.dot_general(
            jnp.asarray(aq_j), jnp.asarray(bq_j), dn,
            preferred_element_type=jnp.float32))
        out[0] += 0.5                     # one corrupted output row
        jd, jb = JGd.abft_residual(jnp.asarray(out), jnp.asarray(aq_j),
                                   jnp.asarray(bq_j), dn)
        td, tb = TGd.abft_residual(torch.from_numpy(out), aq_t, bq_t, dn)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5,
                                   atol=1e-6)
        for gcfg in ({}, {"quantize_check": False}):
            jv = JGd.violation(jnp.asarray(out), jnp.asarray(aq_j),
                               jnp.asarray(bq_j), dn, jc,
                               JGd.GuardConfig(**gcfg))
            tv = TGd.violation(torch.from_numpy(out), aq_t, bq_t, dn, tc,
                               TGd.GuardConfig(**gcfg))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
            assert bool(tv.reshape(-1)[0]) and not bool(tv.reshape(-1)[-1])


def test_guard_stats_snapshot_and_events():
    TGd.reset()
    TGd._record("mlp", "matmul", 8, True, torch.tensor([False, True]), 1,
                True, False, 0, 2)
    TGd._record("mlp", "matmul", 8, False, torch.tensor([False, False]), 0,
                False, False, 0, 0)
    snap = TGd.snapshot()
    assert snap["stats"]["mlp|matmul"]["checks"] == 2
    assert TApi.guard_totals()["violations"] == 1
    assert TApi.drain_guard_events() == [{
        "path": "mlp", "op": "matmul", "rows": [False, True], "retries": 1,
        "recovered": True, "unrecovered": False}]
    assert TApi.drain_guard_events() == []
    TApi.reset_guard_stats()
    assert TGd.totals()["checks"] == 0
    TGd.load(snap)
    assert TGd.stats() == snap["stats"]
    TGd.reset()


def test_guard_escalates_on_a_corrupted_op_and_recovers():
    """Regime flips on the activations are detected and the ladder ends
    clean (at the latest on the exact rung, immune to posit-word faults);
    outside the plan's window the guarded op equals the plain one."""
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(4, 64)).astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(3).normal(
        size=(64, 32)).astype(np.float32))
    cfg = TEC(mode="posit", width=16)
    dn = (((1,), (0,)), ((), ()))
    clean = get_backend("lax_ref").dot_general(x, w, dn, cfg)
    gb = guarded("faulty:lax_ref", TGd.GuardConfig(record="full"))
    plan = TF.FaultPlan(seed=9, rate=0.2, role="regime_run", end_step=1)
    TGd.reset()
    with TF.inject(plan, 11, 0):
        out = gb.dot_general(x, w, dn, cfg)
    t = TGd.totals(reset=True)
    assert t["checks"] == 1 and t["violations"] == 1
    assert t["recovered"] == 1 and t["unrecovered"] == 0 and t["retries"] >= 1
    assert torch.isfinite(out).all()
    with TF.inject(plan, 11, 1):               # outside the window: clean
        assert torch.equal(gb.dot_general(x, w, dn, cfg), clean)
    TGd.reset()


# ---------------------------------------------------------------------------
# the guarded SMOKE model against the JAX model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference():
    """Weights and the JAX model's prefill and decode-step logits under
    lax_ref, the guard's base: on a clean pass the JAX guard returns the
    base op's output unchanged (``guards.py:425-445``), so these are also
    the guarded JAX model's logits."""
    jp = JModel(JG.SMOKE, remat=False).init(jax.random.PRNGKey(0))
    jn = JN.from_ecfg(j_variant(16, "L-21b"), backend="lax_ref")
    jm, jctx = JModel(JG.SMOKE, remat=False, numerics=jn), JCtx(numerics=jn)
    ids = np.random.default_rng(0).integers(0, JG.SMOKE.vocab, (2, 16)).astype(
        np.int32)
    jl, jc = jm.prefill(jp, jnp.asarray(ids), jctx,
                        jm.init_cache(2, 32, jnp.uint16))
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    pos = np.asarray([16, 16], np.int32)
    jd, _ = jm.decode_step(jp, jnp.asarray(tok), jnp.asarray(pos), jc, jctx)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), TG.SMOKE, device="cpu")
    return tp, ids, tok, pos, np.asarray(jl), np.asarray(jd)


@pytest.mark.parametrize("tbase", ["lax_ref", "cuda"])
def test_guarded_smoke_logits_match_reference(reference, tbase):
    """Prefill and one decode step of gemma2-2b SMOKE through guarded:<base>
    (the cuda base runs its kernels' plain versions on the CPU) within the
    model bar of rtol 1e-4 / atol 2e-3 of the JAX model, zero violations."""
    tp, ids, tok, pos, jl, jd = reference
    gb = guarded(tbase, TGd.GuardConfig(record="full"))
    tn = TN.from_ecfg(t_variant(16, "L-21b"), backend=gb.name)
    tm, tctx = TModel(TG.SMOKE, numerics=tn, device="cpu"), TCtx(numerics=tn)
    TGd.reset()
    tl, tc = tm.prefill(tp, torch.from_numpy(ids), tctx,
                        tm.init_cache(2, 32, "uint16"))
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-4, atol=2e-3)
    tl, _ = tm.decode_step(tp, torch.from_numpy(tok), torch.from_numpy(pos),
                           tc, tctx)
    np.testing.assert_allclose(tl.numpy(), jd, rtol=1e-4, atol=2e-3)
    t = TGd.totals(reset=True)
    assert t["checks"] > 0 and t["violations"] == 0, t
