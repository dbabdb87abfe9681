"""The port's serving tier: allocator properties, the RequestBatcher drain
against the JAX scheduler, paged == dense within the port, the OOM
ladder, rejection, the launcher, and the package's isolation from JAX."""
import ast
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import gemma2_2b as JG
from repro.core.engine import EulerConfig as JEulerConfig
from repro.models.layers import Ctx as JCtx
from repro.models.transformer import Model as JModel
from repro.serving import GenerationConfig as JGen
from repro.serving import RequestBatcher as JBatcher
from repro.serving import ServeEngine as JEngine
from repro_torch.configs import gemma2_2b as TG
from repro_torch.core.engine import EulerConfig, from_variant
from repro_torch.models.layers import Ctx
from repro_torch.models.transformer import Model, params_from_jax
from repro_torch.numerics import NumericsContext
from repro_torch.serving import (GenerationConfig, PageAllocator,
                                 PagedKVCache, PagedKVConfig, PagePoolOOM,
                                 RequestBatcher, ServeEngine)
from repro_torch.serving.kvcache import NULL_PAGE, RESERVED_PAGES, TRASH_PAGE

torch.set_num_threads(1)

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"


@pytest.fixture(scope="module")
def weights():
    jp = JModel(JG.SMOKE, remat=False).init(jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), TG.SMOKE,
                               device="cpu")


def _prompts(n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, JG.SMOKE.vocab, int(rng.integers(3, 30))).astype(
        np.int32) for _ in range(n)]


def _drain(eng, prompts, gen, buckets=tuple(range(8, 64, 8))):
    b = RequestBatcher(eng, prompt_buckets=buckets)
    for p in prompts:
        b.submit(p, max_new=gen.max_new_tokens)
    return b.run(gen), b


def _engine(params, backend="exact", cache_dtype="float32", paged=None,
            batch=2, max_len=64, variant="L-21b"):
    cfg = (EulerConfig(mode="exact") if backend == "exact"
           else from_variant(16, variant))
    nctx = NumericsContext.from_ecfg(cfg, backend=backend)
    m = Model(TG.SMOKE, numerics=nctx, device="cpu")
    return ServeEngine(m, params, Ctx(numerics=nctx), max_len=max_len,
                       batch=batch, cache_dtype=cache_dtype, paged=paged)


# ---------------------------------------------------------------------------
# allocator properties (as tests/test_kvcache.py holds the reference to)
# ---------------------------------------------------------------------------

def test_allocator_never_hands_out_reserved_pages():
    a = PageAllocator(10)
    pages = [a.alloc() for _ in range(a.free_count)]
    assert min(pages) == RESERVED_PAGES
    assert NULL_PAGE not in pages and TRASH_PAGE not in pages
    assert sorted(pages) == list(range(RESERVED_PAGES, 10))


def test_allocator_alloc_free_reuse_and_oom():
    a = PageAllocator(6)
    p = [a.alloc() for _ in range(4)]
    with pytest.raises(PagePoolOOM):
        a.alloc()
    a.free(p[1])
    assert a.alloc() == p[1]  # LIFO reuse
    with pytest.raises(ValueError):
        a.free(p[2] + 100)
    a.free(p[2])
    with pytest.raises(ValueError):
        a.free(p[2])


def test_allocator_fragmentation_churn_invariants():
    rng = np.random.default_rng(0)
    a = PageAllocator(34)
    live: list[int] = []
    for _ in range(500):
        if live and (rng.random() < 0.5 or a.free_count == 0):
            a.free(live.pop(int(rng.integers(len(live)))))
        else:
            p = a.alloc()
            assert p not in live
            live.append(p)
        assert a.free_count + a.used_count == 34 - RESERVED_PAGES
        assert a.used_count == len(live)
    for p in live:
        a.free(p)
    assert a.free_count == 34 - RESERVED_PAGES


def test_paged_cache_lifecycle():
    kv = PagedKVCache(batch=2, max_len=32, page_size=8, num_pages=10)
    assert kv.alloc_slot(0, 2) == [2, 3]
    kv.grow_slot(0)
    assert kv.table[0].tolist() == [2, 3, 4, NULL_PAGE]
    assert kv.alloc_slot(1, 4) == [5, 6, 7, 8]  # full length: no headroom
    with pytest.raises(ValueError):
        kv.grow_slot(1)  # already at max_len
    small = PagedKVCache(batch=2, max_len=32, page_size=8, num_pages=6)
    small.alloc_slot(0, 3)
    with pytest.raises(PagePoolOOM):
        small.alloc_slot(1, 1)  # one page + one growth page, none free
    kv.free_slot(0)
    kv.free_slot(1)
    assert kv.live_pages == 0 and kv.peak_pages == 7
    t = kv.table_device("cpu")
    assert t.dtype == torch.int32 and not t.any()


def test_paged_config_resolves_pages():
    assert PagedKVConfig(page_size=16).resolve_pages(4, 256) == 4 * 16 + 3
    with pytest.raises(ValueError):
        PagedKVConfig(page_size=16, num_pages=5).resolve_pages(4, 256)


# ---------------------------------------------------------------------------
# scheduler: tokens against the reference, paged == dense, OOM, rejection
# ---------------------------------------------------------------------------

def test_batcher_tokens_match_reference_with_refills(weights):
    """Per-request greedy tokens of a drain with co-scheduling and
    mid-stream refill equal the JAX scheduler's, on exact numerics."""
    jp, tp = weights
    prompts = _prompts()
    jm = JModel(JG.SMOKE, JEulerConfig(mode="exact"), remat=False)
    jeng = JEngine(jm, jp, JCtx(ecfg=jm.ecfg), max_len=64, batch=2)
    jb = JBatcher(jeng, prompt_buckets=tuple(range(8, 64, 8)))
    for p in prompts:
        jb.submit(p, max_new=6)
    want = jb.run(JGen(max_new_tokens=6), key=jax.random.PRNGKey(1))
    got, b = _drain(_engine(tp), prompts, GenerationConfig(max_new_tokens=6))
    assert b.stats["refills"] >= 1
    assert jb.stats["refills"] == b.stats["refills"]
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


@pytest.mark.parametrize("backend,cache_dtype", [("exact", "float32"),
                                                 ("lax_ref", "uint16")])
def test_batcher_paged_matches_dense_with_refills(weights, backend,
                                                  cache_dtype):
    _, tp = weights
    prompts = _prompts(6, seed=1)
    gen = GenerationConfig(max_new_tokens=7)
    res_d, bd = _drain(_engine(tp, backend, cache_dtype), prompts, gen)
    eng_p = _engine(tp, backend, cache_dtype, PagedKVConfig(page_size=8))
    res_p, bp = _drain(eng_p, prompts, gen)
    assert bd.stats["refills"] >= 1 and bp.stats["refills"] >= 1
    assert set(res_d) == set(res_p)
    for rid in res_d:
        np.testing.assert_array_equal(res_d[rid], res_p[rid])
    assert eng_p.kv.peak_pages < 2 * eng_p.kv.n_logical


def test_oom_ladder_preempts_and_keeps_tokens(weights):
    """A pool one full slot + headroom large: admission backpressure and
    decode-time preemption happen, and greedy recompute gives the same
    tokens as a roomy pool."""
    _, tp = weights
    prompts = _prompts(4, seed=2)
    gen = GenerationConfig(max_new_tokens=12)
    roomy, _ = _drain(_engine(tp, paged=PagedKVConfig(page_size=8),
                              max_len=32), prompts, gen)
    tight_eng = _engine(tp, paged=PagedKVConfig(page_size=8, num_pages=7),
                        max_len=32)
    tight, b = _drain(tight_eng, prompts, gen)
    assert b.stats["kv_oom"] + b.stats["preempts"] >= 1
    for rid in roomy:
        np.testing.assert_array_equal(tight[rid], roomy[rid])


def test_prompt_over_max_len_is_rejected(weights):
    _, tp = weights
    eng = _engine(tp, paged=PagedKVConfig(page_size=8), max_len=32)
    b = RequestBatcher(eng)
    ok = b.submit(np.arange(1, 6, dtype=np.int32), max_new=3)
    bad = b.submit(np.arange(1, 40, dtype=np.int32), max_new=3)
    res = b.run(GenerationConfig(max_new_tokens=3))
    assert b.statuses[bad] == "rejected" and len(res[bad]) == 0
    assert b.statuses[ok] == "ok" and len(res[ok]) == 3
    assert b.stats["rejected"] == 1


def test_eos_retires_request_and_refills(weights):
    """A request that emits the EOS id stops there (EOS included) and its
    slot is refilled; the others run to their budget."""
    _, tp = weights
    prompts = _prompts(3, seed=3)
    free, _ = _drain(_engine(tp), prompts, GenerationConfig(max_new_tokens=5))
    eos = int(free[0][1])
    got, b = _drain(_engine(tp), prompts,
                    GenerationConfig(max_new_tokens=5, eos_id=eos))
    for rid, toks in free.items():
        hits = [i for i, t in enumerate(toks.tolist()) if t == eos]
        want = toks[:hits[0] + 1] if hits else toks
        np.testing.assert_array_equal(got[rid], want)
    assert len(got[0]) == 2
    assert any(e[0] == "refill" for e in b.events)


# ---------------------------------------------------------------------------
# launcher and isolation
# ---------------------------------------------------------------------------

def test_launcher_serves_smoke_on_cpu():
    from repro_torch.launch import serve
    rep = serve.main(["--device", "cpu", "--paged", "--cache-dtype",
                      "uint16", "--backend", "cuda", "--requests", "2",
                      "--max-new", "3", "--batch", "2", "--max-len", "64"])
    assert rep["tokens"] == 6 and rep["requests"] == 2
    assert rep["device"] == "cpu"


def test_launcher_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--device", "cuda"])


def _modules():
    for f in sorted(PKG.rglob("*.py")):
        rel = f.relative_to(SRC).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts), f


def test_package_imports_without_jax_or_reference():
    mods = [m for m, _ in _modules()]
    code = ("import sys\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
            "print(len(" + repr(mods) + "), bad)\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC),
                                         "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]


def test_source_has_no_jax_or_reference_imports():
    offenders = []
    for mod, f in _modules():
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    offenders.append((mod, n))
    assert not offenders, offenders
