"""The port's fault-tolerant scheduler, within the port: deadlines, queue
admission, the SLO degradation policy, isolation of mixed precision-ladder
levels (dense and paged), live fault plans, guard-triggered retry, and the
launcher's guard/ladder flags.  The invariants are those the JAX suite
holds its scheduler to (``tests/test_serving.py:376-535``)."""
import numpy as np
import pytest
import torch

from repro.serving import DegradeController as JDegrade
from repro.serving import SLOConfig as JSLO
from repro_torch.core.engine import EulerConfig
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Ctx
from repro_torch.models.transformer import Model
from repro_torch.numerics import (NumericsContext, PrecisionPolicy,
                                  reset_guard_stats)
from repro_torch.numerics.backends import faulty, guarded
from repro_torch.reliability.faults import FaultPlan
from repro_torch.reliability.guards import GuardConfig
from repro_torch.serving import (DegradeController, GenerationConfig,
                                 PagedKVConfig, QueueFullError,
                                 RequestBatcher, ServeEngine, SLOConfig,
                                 make_key, split_key)

torch.set_num_threads(1)

SUB = split_key(make_key())[1]   # the prefills' sub-key (greedy ignores it)

CFG = ModelConfig(name="srv", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
                  loss_chunk=32, q_chunk=32, kv_chunk=32)


@pytest.fixture(scope="module")
def model_params():
    m = Model(CFG, EulerConfig(mode="exact"), device="cpu")
    return m, m.init(0), Ctx(ecfg=m.ecfg)


@pytest.fixture()
def engine2(model_params):
    """batch=2 dense engine (fresh per test: the scheduler mutates it)."""
    m, params, ctx = model_params
    return ServeEngine(m, params, ctx, max_len=64, batch=2,
                       cache_dtype="float32")


class _TickClock:
    """Deterministic clock: every call advances a fixed number of seconds."""

    def __init__(self, dt=0.1):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        self.t += self.dt
        return self.t


def _single(eng, prompt, max_new, buckets=(8, 16)):
    b = RequestBatcher(eng, prompt_buckets=buckets)
    rid = b.submit(prompt, max_new=max_new)
    return b.run()[rid]


def _nctx(mode, width=16, backend="lax_ref", **kw):
    ecfg = (EulerConfig(mode="exact") if mode == "exact"
            else EulerConfig(mode=mode, width=width, **kw))
    return NumericsContext(policy=PrecisionPolicy.uniform(ecfg),
                           backend=backend)


# The ladder's isolation is exact only where no op couples the rows of a
# batch.  A per-tensor ``pre_scale`` does: the pow2 scale of an activation
# is taken over every row (``_pow2_scale``, the same in the JAX package), so
# a slot's posit rounding depends on its neighbours.  The demoted level
# below quantizes without pre-scale, so the comparison isolates the engine;
# ``test_pre_scale_couples_co_scheduled_rows`` shows the coupling.
def _ladder(pre_scale=False):
    return _nctx("exact"), _nctx("posit", 8, pre_scale=pre_scale)


# ---------------------------------------------------------------------------
# deadlines and admission control
# ---------------------------------------------------------------------------

def test_deadline_timeout_neighbours_bit_identical(engine2):
    """A deadline-expired request retires mid-stream with status "timeout"
    and partial tokens; its neighbour's tokens equal a single-request run."""
    rng = np.random.default_rng(11)
    p_a = rng.integers(0, CFG.vocab, 6)
    p_b = rng.integers(0, CFG.vocab, 9)
    b = RequestBatcher(engine2, prompt_buckets=(8, 16), clock=_TickClock())
    ra = b.submit(p_a, max_new=12)                      # no deadline
    rb = b.submit(p_b, max_new=12, deadline_ms=1200.0)  # dies mid-decode
    res = b.run()
    assert b.statuses[rb] == "timeout" and b.statuses[ra] == "ok"
    assert 0 < len(res[rb]) < 12, "timeout should leave partial tokens"
    assert b.stats["timeouts"] == 1
    assert [e[:3] for e in b.events if e[0] == "timeout"] == [
        ("timeout", rb, 1)]
    np.testing.assert_array_equal(res[ra], _single(engine2, p_a, 12))


def test_deadline_expired_in_queue_never_admitted(engine2):
    rng = np.random.default_rng(12)
    b = RequestBatcher(engine2, prompt_buckets=(8,), clock=_TickClock())
    ra = b.submit(rng.integers(0, CFG.vocab, 4), max_new=10)
    rb = b.submit(rng.integers(0, CFG.vocab, 4), max_new=10)
    rc = b.submit(rng.integers(0, CFG.vocab, 4), max_new=10,
                  deadline_ms=200.0)  # expires before a slot frees
    res = b.run()
    assert b.statuses[rc] == "timeout" and len(res[rc]) == 0
    assert all(len(res[r]) == 10 for r in (ra, rb))
    admitted = {rid for ev, rid, *_ in b.events if ev in ("admit", "refill")}
    assert rc not in admitted


def test_max_queue_raises_queue_full(engine2):
    b = RequestBatcher(engine2, prompt_buckets=(8,), max_queue=2)
    b.submit([1, 2, 3], max_new=2)
    b.submit([1, 2, 3], max_new=2)
    with pytest.raises(QueueFullError):
        b.submit([1, 2, 3], max_new=2)
    assert len(b.run()) == 2


# ---------------------------------------------------------------------------
# the SLO-driven precision ladder
# ---------------------------------------------------------------------------

def test_degrade_controller_policy_matches_reference():
    with pytest.raises(ValueError, match="queue_hi"):
        SLOConfig(queue_hi=0)
    with pytest.raises(ValueError, match="window"):
        SLOConfig(queue_hi=2, window=0)
    c = DegradeController(SLOConfig(queue_hi=4, p99_ms=50.0, window=8),
                          n_levels=3)
    assert [c.admission_level(q) for q in (0, 4, 8, 40)] == [0, 1, 2, 2]
    for _ in range(8):
        c.record_step(100.0)                   # p99 breach adds one level
    assert c.admission_level(0) == 1 and c.admission_level(4) == 2
    # the same observations through both controllers, decision by decision
    rng = np.random.default_rng(5)
    for slo in ({"queue_hi": 3, "p99_ms": 40.0, "window": 5},
                {"queue_hi": 1}, {"queue_hi": 2, "p99_ms": 10.0}):
        tc = DegradeController(SLOConfig(**slo), n_levels=3)
        jc = JDegrade(JSLO(**slo), n_levels=3)
        for lat, depth in zip(rng.uniform(0, 80, 50), rng.integers(0, 9, 50)):
            tc.record_step(lat)
            jc.record_step(lat)
            assert tc.p99_ms() == jc.p99_ms()
            assert tc.admission_level(int(depth)) == jc.admission_level(
                int(depth))


def test_slo_degradation_mixed_levels_isolated(model_params):
    """Under queue pressure one admission is demoted; the level-0 request
    co-scheduled with it and the demoted request each equal a run on an
    engine whose only level is theirs."""
    m, params, ctx = model_params
    hi, lo = _ladder()
    eng = ServeEngine(m, params, ctx, max_len=64, batch=2,
                      cache_dtype="float32", levels=[hi, lo])
    assert eng.n_levels == 2
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, CFG.vocab, 5) for _ in range(4)]
    b = RequestBatcher(eng, prompt_buckets=(8,), slo=SLOConfig(queue_hi=3))
    rids = [b.submit(p, max_new=6) for p in prompts]
    res = b.run()
    # first admission saw queue depth 3 -> level 1; the rest level 0
    assert b.stats["demotions"] == 1 and b.stats["mixed_steps"] > 0
    for rid, prompt, nctx in ((rids[1], prompts[1], hi),
                              (rids[0], prompts[0], lo)):
        one = ServeEngine(m, params, ctx, max_len=64, batch=2,
                          cache_dtype="float32", numerics=nctx)
        np.testing.assert_array_equal(res[rid], _single(one, prompt, 6, (8,)))


def test_pre_scale_couples_co_scheduled_rows(model_params):
    """With a pre-scaled demoted level the same drain's demoted request no
    longer equals its one-level run: its neighbour's activations move the
    per-tensor scale.  (The reference design; the isolation tests above
    use a level without pre-scale.)"""
    m, params, ctx = model_params
    hi, lo = _ladder(pre_scale=True)
    eng = ServeEngine(m, params, ctx, max_len=64, batch=2,
                      cache_dtype="float32", levels=[hi, lo])
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, CFG.vocab, 5) for _ in range(4)]
    b = RequestBatcher(eng, prompt_buckets=(8,), slo=SLOConfig(queue_hi=3))
    rids = [b.submit(p, max_new=6) for p in prompts]
    res = b.run()
    one = ServeEngine(m, params, ctx, max_len=64, batch=2,
                      cache_dtype="float32", numerics=lo)
    assert not np.array_equal(res[rids[0]], _single(one, prompts[0], 6, (8,)))


def _paged_engine(model_params, **kw):
    m, params, ctx = model_params
    return ServeEngine(m, params, ctx, max_len=64, batch=2,
                       cache_dtype="uint16",
                       paged=PagedKVConfig(page_size=8), **kw)


def _slot_words(eng, slot):
    """The slot's mapped pages of every layer's K and V pool, in logical
    order."""
    pages = [p for p in eng.kv.table[slot].tolist() if p >= 2]
    return {k: pool[:, pages].clone() for k, pool in eng.cache.items()}


def test_paged_mixed_levels_write_only_their_own_pages(model_params):
    """Two slots at two ladder levels step through ONE page pool: each
    slot's tokens and every word of its pages equal a run on a one-level
    engine with only that slot active, bit for bit."""
    hi, lo = _ladder()
    rng = np.random.default_rng(22)
    prompts = [rng.integers(0, CFG.vocab, 8).astype(np.int32)
               for _ in range(2)]
    gen = GenerationConfig(max_new_tokens=8)
    mixed = _paged_engine(model_params, levels=[hi, lo])
    first = [mixed.prefill_slot(s, prompts[s], gen, SUB, level=s)
             for s in range(2)]
    tok, pos = np.asarray(first, np.int32), np.asarray([8, 8])
    toks = []
    for _ in range(5):
        for s in range(2):
            mixed.ensure_slot_pages(s, pos[s])
        tok, _ = mixed.step_slots(gen, tok, pos, [True, True], make_key(),
                                  level=[0, 1])
        toks.append(tok)
        pos = pos + 1
    for s, nctx in enumerate((hi, lo)):
        one = _paged_engine(model_params, numerics=nctx)
        t = np.asarray([0, 0], np.int32)
        t[s] = one.prefill_slot(s, prompts[s], gen, SUB)
        assert t[s] == first[s]
        p = np.asarray([8, 8])
        act = [i == s for i in range(2)]
        for k in range(5):
            one.ensure_slot_pages(s, p[s])
            t, _ = one.step_slots(gen, t, p, act, make_key())
            assert t[s] == toks[k][s], (s, k)
            p = p + 1
        want, got = _slot_words(one, s), _slot_words(mixed, s)
        for name in want:
            assert torch.equal(got[name], want[name]), (s, name)


def test_paged_ladder_drain_matches_single_level_runs(model_params):
    """The batcher over a paged two-level engine: every request's tokens
    equal its run on a paged engine with only its admission level."""
    hi, lo = _ladder()
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, CFG.vocab, int(n)) for n in (5, 11, 7)]
    eng = _paged_engine(model_params, levels=[hi, lo])
    b = RequestBatcher(eng, slo=SLOConfig(queue_hi=2))
    rids = [b.submit(p, max_new=5) for p in prompts]
    res = b.run()
    assert b.stats["demotions"] == 1 and b.stats["mixed_steps"] > 0
    levels = {rid: (1 if i == 0 else 0) for i, rid in enumerate(rids)}
    for rid, prompt in zip(rids, prompts):
        one = _paged_engine(model_params, numerics=(hi, lo)[levels[rid]])
        bb = RequestBatcher(one)
        r = bb.submit(prompt, max_new=5)
        np.testing.assert_array_equal(res[rid], bb.run()[r])


# ---------------------------------------------------------------------------
# live fault plans and guard-triggered retry
# ---------------------------------------------------------------------------

def test_fault_plan_spares_prefill_and_corrupts_decode(model_params):
    m, params, ctx = model_params
    nctx = _nctx("posit", 16, backend=faulty("lax_ref").name)
    prompts = [np.arange(1, 7), np.arange(9, 14)]
    clean = ServeEngine(m, params, ctx, max_len=64, batch=2,
                        cache_dtype="float32", numerics=nctx)
    hit = ServeEngine(m, params, ctx, max_len=64, batch=2,
                      cache_dtype="float32", numerics=nctx,
                      fault=FaultPlan(seed=3, rate=0.5, role="regime_run"))
    out = []
    for eng in (clean, hit):
        b = RequestBatcher(eng, prompt_buckets=(8,))
        rids = [b.submit(p, max_new=8) for p in prompts]
        out.append(b.run())
        assert eng.fault_step == b.stats["steps"]
    for rid in rids:
        assert out[0][rid][0] == out[1][rid][0]   # the prefill token
    assert any(not np.array_equal(out[0][r], out[1][r]) for r in rids)


def _guarded_engine(model_params, plan):
    reset_guard_stats()  # no events left over from other tests
    m, params, ctx = model_params
    gb = guarded(faulty("lax_ref"),
                 GuardConfig(record="events", sentinels=False,
                             max_retries=0, atol=0.0))  # detect-only
    return ServeEngine(m, params, ctx, max_len=64, batch=2,
                       cache_dtype="float32",
                       numerics=_nctx("posit", 16, backend=gb.name),
                       fault=plan)


def test_guard_retry_reenqueues_and_recovers(model_params):
    """An unrecovered violation (detect-only guard) tears the slot down
    before the corrupted token reaches the stream; the re-enqueued request
    decodes clean and equals a fault-free run."""
    eng = _guarded_engine(model_params, FaultPlan(
        seed=5, rate=0.05, role="regime_run", operand="a", end_step=1))
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, CFG.vocab, 5) for _ in range(2)]
    b = RequestBatcher(eng, prompt_buckets=(8,), guard_retry=1)
    rids = [b.submit(p, max_new=6) for p in prompts]
    res = b.run()
    assert b.stats["guard_retries"] >= 1
    assert [e for e in b.events if e[0] == "guard_retry"]
    assert all(b.statuses[r] == "ok" for r in rids)
    m, params, ctx = model_params
    clean = ServeEngine(m, params, ctx, max_len=64, batch=2,
                        cache_dtype="float32", numerics=_nctx("posit", 16))
    for r, p in zip(rids, prompts):
        np.testing.assert_array_equal(res[r], _single(clean, p, 6, (8,)))


def test_guard_retry_exhausted_fails(model_params):
    """A persistent plan trips the guard again on the retry, exhausting the
    single-retry budget: the request retires "failed"."""
    eng = _guarded_engine(model_params, FaultPlan(
        seed=5, rate=0.2, role="regime_run", operand="a"))
    b = RequestBatcher(eng, prompt_buckets=(8,), guard_retry=1)
    rid = b.submit(np.random.default_rng(32).integers(0, CFG.vocab, 5),
                   max_new=6)
    res = b.run()
    assert b.stats["guard_retries"] >= 1
    assert b.statuses[rid] == "failed" and len(res[rid]) < 6


# ---------------------------------------------------------------------------
# the launcher's fault-tolerant flags (phase 3b of chip_smoke, on the CPU)
# ---------------------------------------------------------------------------

def test_serve_guarded_ladder_flags_on_cpu():
    from repro_torch.launch import serve
    rep = serve.main([
        "--device", "cpu", "--paged", "--cache-dtype", "uint16",
        "--backend", "cuda", "--guard", "--width", "16", "--euler", "L-21b",
        "--degrade-ladder", "8", "--slo-queue-hi", "3", "--batch", "4",
        "--max-len", "64", "--requests", "6", "--max-new", "3"])
    assert set(rep["statuses"].values()) == {"ok"} and rep["tokens"] == 18
    assert rep["demotions"] == 3 and rep["mixed_steps"] > 0
    assert rep["guard"]["checks"] > 0 and rep["guard"]["violations"] == 0
    assert rep["launches"]["posit_encode"] == 0   # plain versions on the CPU
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--degrade-ladder", "16"])
