"""Kill-and-resume in the port: a drain killed mid-stream and resumed by a
fresh batcher over a fresh engine emits every request's tokens
bit-identical to the uninterrupted run, over dense and paged uint16
caches, greedy and sampled decoding, a live fault plan and mixed ladder
levels; then the supervisor's restart and its give-up."""
import numpy as np
import pytest
import torch

from repro_torch.configs import mamba2_1p3b as TM
from repro_torch.core.engine import EulerConfig, from_variant
from repro_torch.distributed import failover as F
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Ctx
from repro_torch.models.transformer import Model
from repro_torch.numerics import NumericsContext
from repro_torch.reliability.faults import FaultPlan
from repro_torch.serving import (DurableBatcher, GenerationConfig,
                                 PagedKVConfig, RequestBatcher, ServeEngine,
                                 ServeSupervisor, SimulatedCrash, SLOConfig,
                                 make_key)

torch.set_num_threads(1)


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


CFG = ModelConfig(name="fosrv", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
                  loss_chunk=32, q_chunk=32, kv_chunk=32)
P16 = NumericsContext.from_ecfg(from_variant(16, "L-21b"))
P8 = NumericsContext.from_ecfg(from_variant(8, "L-21b"))


@pytest.fixture(scope="module")
def params():
    return {"dense": Model(CFG, EulerConfig(mode="exact"),
                           device="cpu").init(0),
            "ssm": Model(TM.SMOKE, EulerConfig(mode="exact"),
                         device="cpu").init(0)}


def _prompts(n=5, seed=3, vocab=CFG.vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(3, 12)))
            for _ in range(n)]


def test_sampled_drain_same_key_same_tokens(params):
    def drain(gen, key):
        eng = ServeEngine(Model(CFG, device="cpu"), params["dense"],
                          max_len=64, batch=2, cache_dtype="float32")
        b = RequestBatcher(eng, prompt_buckets=(32,))
        for p in _prompts():
            b.submit(p, max_new=8)
        return b.run(gen, key=key)

    def same(a, b):
        return all(np.array_equal(a[r], b[r]) for r in a)

    greedy = GenerationConfig(max_new_tokens=8)
    assert same(drain(greedy, make_key(1)), drain(greedy, make_key(2)))
    hot = GenerationConfig(max_new_tokens=8, temperature=1.5)
    a, b = drain(hot, make_key(1)), drain(hot, make_key(1))
    assert same(a, b)
    assert not same(a, drain(hot, make_key(2)))


# ---------------------------------------------------------------------------
# kill-and-resume, bit-identical
# ---------------------------------------------------------------------------

CASES = {
    "dense-greedy": dict(),
    "paged-u16-greedy": dict(paged=True, numerics=P16),
    "dense-sampled": dict(gen=dict(temperature=0.9)),
    "paged-u16-sampled-topk": dict(paged=True, numerics=P16,
                                   gen=dict(temperature=0.9, top_k=5)),
    "paged-u16-fault-plan": dict(paged=True, fault=True, gen=dict(
        temperature=0.9), numerics=NumericsContext.from_ecfg(
            from_variant(16, "L-21b"), backend="faulty:lax_ref")),
    "dense-mixed-levels": dict(levels=[P16, P8]),
    "paged-u16-mixed-levels-sampled": dict(paged=True, levels=[P16, P8],
                                           gen=dict(temperature=0.9)),
    "ssm-dense-sampled": dict(arch="ssm", numerics=P16,
                              gen=dict(temperature=0.9)),
}


def _case_engine(params, case, with_fault=True):
    c = CASES[case]
    arch = c.get("arch", "dense")
    cfg = TM.SMOKE if arch == "ssm" else CFG
    nctx = c.get("numerics", NumericsContext.from_ecfg(
        EulerConfig(mode="exact")))
    m = Model(cfg, numerics=nctx, device="cpu")
    fault = (FaultPlan(seed=4, rate=0.05, role="fraction", operand="a",
                       record=True)
             if c.get("fault") and with_fault else None)
    return ServeEngine(m, params[arch], Ctx(numerics=nctx), max_len=64,
                       batch=2, cache_dtype="uint16" if c.get("paged")
                       else "float32",
                       paged=PagedKVConfig(page_size=8) if c.get("paged")
                       else None, levels=c.get("levels"), fault=fault)


def _case_batcher(eng, case, cls=RequestBatcher, **kw):
    c = CASES[case]
    slo = SLOConfig(queue_hi=2) if c.get("levels") else None
    return cls(eng, prompt_buckets=(32,), slo=slo, **kw)


def _case_run(b, case, key, **kw):
    c = CASES[case]
    vocab = TM.SMOKE.vocab if c.get("arch") == "ssm" else CFG.vocab
    for p in _prompts(vocab=vocab):
        b.submit(p, max_new=8)
    gen = GenerationConfig(max_new_tokens=8, eos_id=7, **c.get("gen", {}))
    return b.run(gen, key=key, **kw)


def _slot_caches(eng) -> dict:
    """{leaf: [per-slot cache contents]}: dense rows, or a paged slot's
    mapped pages in logical order."""
    if eng.kv is None:
        return {k: list(a.unbind(1)) for k, a in eng.cache.items()}
    return {k: [pool[:, eng.kv.pages_of(s)] for s in range(eng.batch)]
            for k, pool in eng.cache.items()}


@pytest.mark.parametrize("kill", ["early", "late"])
@pytest.mark.parametrize("case", list(CASES))
def test_kill_and_resume_tokens_identical(params, case, kill, tmp_path):
    """A drain killed mid-stream and resumed by a fresh batcher over a
    fresh engine (its fault plan, key and page tables from the snapshot
    alone) emits every request's tokens bit-identical to the uninterrupted
    run.  "early": requests still queued; "late": two steps before the
    end, with the queue drained and a retired slot's pad row in the
    batch."""
    from repro_torch.reliability import faults
    faults.injection_stats(reset=True)
    base_b = _case_batcher(_case_engine(params, case), case)
    base = _case_run(base_b, case, make_key(11))
    if CASES[case].get("fault"):
        assert faults.injection_stats()["words"] > 0  # the plan landed
    b1 = _case_batcher(_case_engine(params, case), case, DurableBatcher,
                       ckpt_dir=str(tmp_path), snapshot_every=1)
    kill_at = 3 if kill == "early" else base_b.stats["steps"] - 2
    partial = _case_run(b1, case, make_key(11), max_steps=kill_at)
    assert len(partial) < len(base)  # requests really were in flight
    if kill == "late":
        assert not b1.queue and not b1._state.active.all()
    b2 = _case_batcher(_case_engine(params, case, with_fault=False), case,
                       DurableBatcher, ckpt_dir=str(tmp_path),
                       snapshot_every=1)
    res = b2.resume()
    assert set(res) == set(base)
    for rid in base:
        np.testing.assert_array_equal(res[rid], base[rid], err_msg=str(rid))
    assert b2.stats == base_b.stats
    # the resumed engine ends in the uninterrupted one's state: every
    # slot's cache rows (paged: its pages in logical order) bit for bit
    want, got = _slot_caches(base_b.engine), _slot_caches(b2.engine)
    for name in want:
        for s, (w, g) in enumerate(zip(want[name], got[name])):
            assert torch.equal(w, g), (name, s)
    if CASES[case].get("levels"):
        assert base_b.stats["mixed_steps"] > 0
    if CASES[case].get("fault"):
        assert b2.engine.fault is not None


def test_resume_refuses_a_layout_mismatch(params, tmp_path):
    b1 = _case_batcher(_case_engine(params, "paged-u16-greedy"),
                       "paged-u16-greedy", DurableBatcher,
                       ckpt_dir=str(tmp_path), snapshot_every=1)
    _case_run(b1, "paged-u16-greedy", make_key(0), max_steps=1)
    b2 = _case_batcher(_case_engine(params, "dense-greedy"), "dense-greedy",
                       DurableBatcher, ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="layout mismatch"):
        b2.resume()


def test_paged_snapshot_claims_exact_pages():
    from repro_torch.serving import PagedKVCache
    kv = PagedKVCache(batch=2, max_len=32, page_size=8, num_pages=10)
    kv.alloc_slot(0, 2)
    kv.alloc_slot(1, 1)
    kv.free_slot(0)
    kv.alloc_slot(0, 3)
    snap = kv.snapshot()
    fresh = PagedKVCache(batch=2, max_len=32, page_size=8, num_pages=10)
    fresh.load(snap)
    assert fresh.table.tolist() == kv.table.tolist()
    assert fresh.live_pages == kv.live_pages
    dup = dict(snap, slot_pages=[[2, 3], [3]])
    with pytest.raises(ValueError, match="claimed twice"):
        PagedKVCache(2, 32, 8, 10).load(dup)
    with pytest.raises(ValueError, match="geometry"):
        PagedKVCache(2, 32, 8, 12).load(snap)


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

def _supervised(params, tmp_path, crash_at, max_restarts=3):
    clk = Clock()
    clk.t = 100.0
    crashes = {"n": 0}

    def boom(step):
        if step == crash_at and (crash_at == 2 or crashes["n"] == 0):
            crashes["n"] += 1
            raise SimulatedCrash("kill -9")

    def mk():
        return _case_batcher(_case_engine(params, "dense-sampled"),
                             "dense-sampled", DurableBatcher,
                             ckpt_dir=str(tmp_path), snapshot_every=1,
                             on_step=boom)

    sup = ServeSupervisor(mk, dead_after_s=5.0, clock=clk,
                          max_restarts=max_restarts)

    def submit(b):
        for p in _prompts():
            b.submit(p, max_new=8)

    gen = GenerationConfig(max_new_tokens=8, eos_id=7, temperature=0.9)
    return sup, crashes, lambda: sup.run(submit, gen, key=make_key(11))


def test_supervisor_restarts_after_crash(params, tmp_path):
    sup, crashes, run = _supervised(params, tmp_path, crash_at=3)
    res = run()
    assert crashes["n"] == 1 and sup.restarts == 1
    assert [d.action for d in sup.decisions] == [F.Action.ELASTIC_DOWN]
    base = _case_run(_case_batcher(_case_engine(params, "dense-sampled"),
                                   "dense-sampled"), "dense-sampled",
                     make_key(11))
    assert set(res) == set(base)
    for rid in base:
        np.testing.assert_array_equal(res[rid], base[rid])


def test_supervisor_gives_up_after_max_restarts(params, tmp_path):
    sup, crashes, run = _supervised(params, tmp_path, crash_at=2,
                                    max_restarts=2)
    with pytest.raises(SimulatedCrash):
        run()
    assert sup.restarts == 2 and crashes["n"] == 3
