"""The port's ssm and hybrid families against the JAX reference: the SSD
mixer (``ssd_chunked``, ``ssm_apply`` prefill and decode, the cache
reset), prefill + decode == forward, a hybrid with a local layer through
``params_from_jax``, the batcher's greedy tokens, the launcher, and the
refusal of a paged cache.  ``test_torch_ssm_models.py`` holds the mamba2
and hymba SMOKE models on both routes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import hymba_1p5b as JH
from repro.configs import mamba2_1p3b as JM
from repro.core.engine import from_variant as j_variant
from repro.models import ssm as JS
from repro.models.config import ModelConfig as JConfig
from repro.models.layers import Ctx as JCtx
from repro.models.transformer import Model as JModel
from repro.numerics import NumericsContext as JN
from repro.serving import GenerationConfig as JGen
from repro.serving import RequestBatcher as JBatcher
from repro.serving import ServeEngine as JEngine
from repro_torch.configs import hymba_1p5b as TH
from repro_torch.configs import mamba2_1p3b as TM
from repro_torch.core.engine import EulerConfig
from repro_torch.core.engine import from_variant as t_variant
from repro_torch.models import ssm as TS
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.layers import Ctx as TCtx
from repro_torch.models.transformer import Model as TModel, params_from_jax
from repro_torch.numerics import NumericsContext as TN
from repro_torch.serving import GenerationConfig, RequestBatcher, ServeEngine

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=2e-3)
# a hybrid whose layer 1 is local with a window (8) shorter than the prompts
# (hymba SMOKE's three layers are all global by layer_kind)
LOCAL_HYBRID = dict(name="hyb-local", family="hybrid", n_layers=4,
                    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                    d_ff=128, vocab=256, ssm_state=8, ssm_head_dim=16,
                    ssm_chunk=8, n_global_layers=1, window=8,
                    loss_chunk=32, q_chunk=16, kv_chunk=16)
ARCHS = {"mamba2": (JM.SMOKE, TM.SMOKE), "hymba": (JH.SMOKE, TH.SMOKE),
         "hybrid-local": (JConfig(**LOCAL_HYBRID), TConfig(**LOCAL_HYBRID))}
BACKENDS = {"exact": ("exact", "exact"), "lax_ref": ("lax_ref", "lax_ref"),
            "cuda": ("pallas", "cuda")}


def _nctx(backend):
    jb, tb = BACKENDS[backend]
    if backend == "exact":
        return (JN.from_ecfg(j_variant(16, "L-21b").replace(mode="exact")),
                TN.from_ecfg(EulerConfig(mode="exact")))
    return (JN.from_ecfg(j_variant(16, "L-21b"), backend=jb),
            TN.from_ecfg(t_variant(16, "L-21b"), backend=tb))


@pytest.fixture(scope="module")
def weights():
    """{arch: (jax params, port params)} from one seed."""
    out = {}
    for name, (jc, tc) in ARCHS.items():
        jp = JModel(jc, remat=False).init(jax.random.PRNGKey(0))
        out[name] = (jp, params_from_jax(jax.tree.map(np.asarray, jp), tc,
                                         device="cpu"))
    return out


def _mixer_params(weights):
    jp, tp = weights["mamba2"]
    return (jax.tree.map(lambda a: a[0], jp["layers"]["ssm"]),
            tp["layers"][0]["ssm"])


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["exact", "lax_ref"])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(backend, with_state):
    rng = np.random.default_rng(3)
    B, T, H, P, N = 2, 32, 4, 8, 16
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (B, T, H)).astype(np.float32)
    A = -rng.uniform(1.0, 8.0, H).astype(np.float32)
    Bm = rng.standard_normal((B, T, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, N)).astype(np.float32)
    S0 = (rng.standard_normal((B, H, N, P)).astype(np.float32)
          if with_state else None)
    jn, tn = _nctx(backend)
    jy, jS = JS.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                            JCtx(numerics=jn), 8,
                            None if S0 is None else jnp.asarray(S0))
    ty, tS = TS.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                            TCtx(numerics=tn), 8,
                            None if S0 is None else torch.from_numpy(S0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tS.numpy(), np.asarray(jS), **TOL)


@pytest.mark.parametrize("backend", ["exact", "lax_ref"])
def test_ssm_apply_prefill_and_decode_match_reference(weights, backend):
    """Prefill writes the final state and conv tail; two decode steps
    then advance both; outputs and caches equal JAX's."""
    jp, tp = _mixer_params(weights)
    cfg = TM.SMOKE
    jn, tn = _nctx(backend)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    xs = [rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
          for _ in range(2)]

    def jax_run(p, x, xs):
        c = JS.ssm_cache_init(JM.SMOKE, 2, jnp.float32)
        y, c = JS.ssm_apply(p, x, JCtx(numerics=jn), JM.SMOKE, c)
        ys = [y]
        for t, xt in enumerate(xs):
            ctx = JCtx(numerics=jn, decode_pos=jnp.int32(16 + t))
            y, c = JS.ssm_apply(p, xt, ctx, JM.SMOKE, c)
            ys.append(y)
        return ys, c

    jys, jc = jax.jit(jax_run)(jp, jnp.asarray(x), [jnp.asarray(v)
                                                    for v in xs])
    tc = TS.ssm_cache_init(cfg, 2, torch.float32, "cpu")
    ty, tc = TS.ssm_apply(tp, torch.from_numpy(x), TCtx(numerics=tn), cfg,
                          tc)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jys[0]), **TOL)
    for t, xt in enumerate(xs):
        tctx = TCtx(numerics=tn, decode_pos=16 + t)
        ty, tc = TS.ssm_apply(tp, torch.from_numpy(xt), tctx, cfg, tc)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jys[t + 1]), **TOL)
    for name in ("state", "conv"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)


@pytest.mark.parametrize("slot", [None, 1])
def test_ssm_cache_reset_matches_reference(slot):
    rng = np.random.default_rng(5)
    cache = {"state": rng.standard_normal((3, 2, 4, 5)).astype(np.float32),
             "conv": rng.standard_normal((3, 3, 6)).astype(np.float32)}
    want = JS.ssm_cache_reset(jax.tree.map(jnp.asarray, cache), slot)
    got = TS.ssm_cache_reset({k: torch.from_numpy(v.copy())
                              for k, v in cache.items()}, slot)
    for k in cache:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def check_logits(jc, tc, jp, tp, jn, tn, steps: int = 2):
    """Prefill and ``steps`` greedy decode steps on both packages (JAX's
    under one jit): logits within rtol 1e-4 / atol 2e-3 of JAX's, the
    port's decode fed JAX's tokens."""
    jm = JModel(jc, remat=False, numerics=jn)
    tm = TModel(tc, numerics=tn, device="cpu")
    ids = np.random.default_rng(7).integers(0, jc.vocab, (2, 16)).astype(
        np.int32)

    def jax_run(p, ids, cache):
        ctx = JCtx(numerics=jn)
        logits, cache = jm.prefill(p, ids, ctx, cache)
        out = [(logits, ids[:, -1])]
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        for t in range(steps):
            logits, cache = jm.decode_step(p, tok, jnp.int32(16 + t), cache,
                                           ctx)
            out.append((logits, tok))
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
        return out

    want = jax.jit(jax_run)(jp, jnp.asarray(ids),
                            jm.init_cache(2, 24, jnp.float32))
    tcache = tm.init_cache(2, 24, "float32")
    tl, tcache = tm.prefill(tp, torch.from_numpy(ids), TCtx(numerics=tn),
                            tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(want[0][0]), **TOL)
    for t, (jl, tok) in enumerate(want[1:]):
        tl, tcache = tm.decode_step(tp, torch.tensor(np.asarray(tok)),
                                    16 + t, tcache, TCtx(numerics=tn))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("arch", ["mamba2", "hybrid-local"])
def test_prefill_decode_matches_forward(weights, arch):
    """Teacher-forced decode reproduces the full-forward logits (the
    counterpart of the reference's test for the ssm/hybrid families)."""
    _, tc = ARCHS[arch]
    _, tp = weights[arch]
    m = TModel(tc, EulerConfig(mode="exact"), device="cpu")
    ctx = m.make_ctx()
    B, T, Tp = 2, 32, 16
    ids = torch.from_numpy(np.random.default_rng(6).integers(
        0, tc.vocab, (B, T)).astype(np.int32))
    hidden, _ = m.forward(tp, ids, ctx)
    full = m.head(tp, hidden, ctx)
    cache = m.init_cache(B, T, "float32")
    logits, cache = m.prefill(tp, ids[:, :Tp], ctx, cache)
    np.testing.assert_allclose(logits.numpy(), full[:, Tp - 1].numpy(),
                               rtol=2e-2, atol=2e-3)
    for t in range(Tp, T - 1):
        logits, cache = m.decode_step(tp, ids[:, t], t, cache, ctx)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   rtol=2e-2, atol=2e-3,
                                   err_msg=f"{arch} pos {t}")


def test_local_hybrid_logits_match_reference(weights):
    """The hybrid with a local layer whose window is shorter than the
    prompt, on the reference engine (the SMOKE models, on both routes,
    are in ``test_torch_ssm_models.py``)."""
    check_logits(*ARCHS["hybrid-local"], *weights["hybrid-local"],
                 *_nctx("lax_ref"))


@pytest.mark.parametrize("arch", ["mamba2", "hymba"])
def test_batcher_tokens_match_reference(weights, arch):
    """Greedy tokens of a drain with co-scheduling and mid-stream refill
    equal the JAX scheduler's, on exact numerics."""
    jc, tc = ARCHS[arch]
    jp, tp = weights[arch]
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, jc.vocab, int(rng.integers(3, 15))).astype(
        np.int32) for _ in range(4)]
    jm = JModel(jc, j_variant(16, "L-21b").replace(mode="exact"),
                remat=False)
    jeng = JEngine(jm, jp, JCtx(ecfg=jm.ecfg), max_len=32, batch=2,
                   cache_dtype=jnp.float32)
    jb = JBatcher(jeng, prompt_buckets=(16,))
    for p in prompts:
        jb.submit(p, max_new=5)
    want = jb.run(JGen(max_new_tokens=5), key=jax.random.PRNGKey(1))
    nctx = TN.from_ecfg(EulerConfig(mode="exact"))
    tm = TModel(tc, numerics=nctx, device="cpu")
    eng = ServeEngine(tm, tp, TCtx(numerics=nctx), max_len=32, batch=2,
                      cache_dtype="float32")
    b = RequestBatcher(eng, prompt_buckets=(16,))
    for p in prompts:
        b.submit(p, max_new=5)
    got = b.run(GenerationConfig(max_new_tokens=5))
    assert b.stats["refills"] >= 1
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_paged_cache_refused(arch):
    from repro_torch.launch import serve
    with pytest.raises(ValueError, match="recurrent state"):
        serve.main(["--device", "cpu", "--arch", arch, "--paged",
                    "--requests", "1", "--max-new", "2"])


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_launcher_serves_new_families(arch):
    from repro_torch.launch import serve
    rep = serve.main(["--device", "cpu", "--arch", arch, "--backend", "cuda",
                      "--requests", "3", "--max-new", "3", "--batch", "2",
                      "--max-len", "64"])
    assert rep["tokens"] == 9 and rep["requests"] == 3
    assert rep["launches"]["paged_flash_decode"] == 0
