"""The port's gemma2-2b SMOKE model against the JAX reference with the same
weights (``params_from_jax``): prefill and decode logits per backend, and
paged == dense decode bit-identical within the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma2_2b as JG
from repro.core.engine import from_variant as j_variant
from repro.models.layers import Ctx as JCtx
from repro.models.transformer import Model as JModel
from repro.numerics import NumericsContext as JN
from repro_torch.configs import gemma2_2b as TG
from repro_torch.core.engine import EulerConfig
from repro_torch.core.engine import from_variant as t_variant
from repro_torch.models.layers import Ctx as TCtx
from repro_torch.models.transformer import Model as TModel, params_from_jax
from repro_torch.numerics import NumericsContext as TN

torch.set_num_threads(1)

CFG = JG.SMOKE


@pytest.fixture(scope="module")
def weights():
    jp = JModel(CFG, remat=False).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), TG.SMOKE, device="cpu")
    return jp, tp


def _models(jbackend, tbackend, variant="L-21b"):
    jn = JN.from_ecfg(j_variant(16, variant), backend=jbackend)
    tn = TN.from_ecfg(t_variant(16, variant), backend=tbackend)
    return (JModel(CFG, remat=False, numerics=jn), JCtx(numerics=jn),
            TModel(TG.SMOKE, numerics=tn, device="cpu"), TCtx(numerics=tn))


@pytest.mark.parametrize("jbackend,tbackend", [("exact", "exact"),
                                               ("lax_ref", "lax_ref"),
                                               ("pallas", "cuda")])
def test_prefill_and_decode_logits_match_reference(weights, jbackend,
                                                   tbackend):
    jp, tp = weights
    jm, jctx, tm, tctx = _models(jbackend, tbackend)
    ids = np.random.default_rng(0).integers(0, CFG.vocab, (2, 16)).astype(
        np.int32)
    jc = jm.init_cache(2, 32, jnp.uint16)
    tc = tm.init_cache(2, 32, "uint16")
    jl, jc = jm.prefill(jp, jnp.asarray(ids), jctx, jc)
    tl, tc = tm.prefill(tp, torch.from_numpy(ids), tctx, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=2e-3)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    pos = np.asarray([16, 16], np.int32)
    for _ in range(3):
        jl, jc = jm.decode_step(jp, jnp.asarray(tok), jnp.asarray(pos), jc,
                                jctx)
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok),
                                torch.from_numpy(pos), tc, tctx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=2e-3)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = pos + 1


@pytest.mark.parametrize("backend,cache_dtype", [("exact", "float32"),
                                                 ("lax_ref", "uint16"),
                                                 ("lax_ref", "uint8")])
def test_decode_step_paged_matches_dense(weights, backend, cache_dtype):
    """Hand-built pool (slot0 -> page 2, slot1 -> page 3, growth pages 4/5
    zeroed, the rest NULL): paged decode logits equal dense ones bit for
    bit on the reference path."""
    _, tp = weights
    _, _, m, ctx = _models(backend, backend, "L-21b")
    B, max_len, ps, Tp = 2, 32, 8, 8
    rng = np.random.default_rng(3)
    prompts = torch.from_numpy(rng.integers(1, CFG.vocab, (B, Tp)).astype(
        np.int32))
    dense = m.init_cache(B, max_len, cache_dtype)
    logits, dense = m.prefill(tp, prompts, ctx, dense)
    pool = m.init_paged_cache(6, ps, cache_dtype)
    for k in ("k", "v"):
        pool[k][:, 2] = dense[k][:, 0, :ps]
        pool[k][:, 3] = dense[k][:, 1, :ps]
    table = torch.tensor([[2, 4, 0, 0], [3, 5, 0, 0]], dtype=torch.int32)
    tok = torch.argmax(logits, -1).to(torch.int32)
    tok_p = tok.clone()
    pos = torch.full((B,), Tp, dtype=torch.int32)
    for _ in range(5):
        ld, dense = m.decode_step(tp, tok, pos, dense, ctx)
        lp, pool = m.decode_step(tp, tok_p, pos, pool, ctx, page_table=table)
        torch.testing.assert_close(lp, ld, rtol=0, atol=0)
        tok = torch.argmax(ld, -1).to(torch.int32)
        tok_p = torch.argmax(lp, -1).to(torch.int32)
        pos = pos + 1
    # the trash and null pages were never written by a live row
    assert not pool["k"][:, 0].any()


def test_layer_windows_and_shapes_match_reference(weights):
    jp, tp = weights
    jm = JModel(CFG, remat=False)
    tm = TModel(TG.SMOKE, device="cpu")
    assert tm.layer_windows() == np.asarray(jm.layer_windows()).tolist()
    assert TModel.param_count(tp) == jm.param_count(jp)
    fresh = tm.init(0)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        node = fresh
        if keys[0] == "layers":
            node = fresh["layers"][0]
            keys = keys[1:]
            shape = leaf.shape[1:]
        else:
            shape = leaf.shape
        for k in keys:
            node = node[k]
        assert tuple(node.shape) == tuple(shape), keys
    e = fresh["embed"]["e"]
    assert abs(float(e.std()) - 0.02) < 2e-3
    w = fresh["layers"][0]["mlp"]["wo"]["w"]
    assert abs(float(w.std()) - CFG.d_ff ** -0.5) < 0.1 * CFG.d_ff ** -0.5


def test_full_config_matches_reference():
    import dataclasses
    assert dataclasses.asdict(TG.FULL) == dataclasses.asdict(JG.FULL)
    assert dataclasses.asdict(TG.SMOKE) == dataclasses.asdict(JG.SMOKE)
    assert TG.EXPECTED == JG.EXPECTED


def test_exact_head_matches_reference_with_bf16(weights):
    """bf16 activations into the exact head, as FULL runs them."""
    jp, tp = weights
    jm, jctx, tm, tctx = _models("exact", "exact")
    h = np.random.default_rng(1).normal(size=(3, CFG.d_model)).astype(
        np.float32)
    jl = jm.head(jp, jnp.asarray(h, jnp.bfloat16), jctx)
    tl = tm.head(tp, torch.from_numpy(h).to(torch.bfloat16), tctx)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=2e-3)


def test_model_refuses_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TModel(TG.SMOKE)
    assert EulerConfig().mode == "euler"
