"""The port's model zoo against the JAX reference: the config registry and
every ``EXPECTED``, ``Model.init`` shapes of all ten SMOKE configs, and the
SMOKE logits of the five non-MoE configs added with the moe/audio/vlm
slice (yi-6b, nemotron-4-15b, gemma2-27b, musicgen-large, chameleon-34b)
on the reference engine and on the kernels' route (their plain versions on
the CPU; JAX's Pallas kernels in interpret mode).

Bars: logits within rtol 1e-4 / atol 2e-3 of JAX's (``tests/
test_numerics.py:279``); shapes and config numbers exactly.  The
llama4-scout and arctic SMOKE logits are held in ``test_torch_moe.py``,
the audio/vlm prefill from embeddings and ``generate`` in
``test_torch_generate.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.core.engine import from_variant as j_variant
from repro.models.layers import Ctx as JCtx
from repro.models.transformer import Model as JModel
from repro.numerics import NumericsContext as JN
from repro_torch import configs as TC
from repro_torch.core.engine import EulerConfig
from repro_torch.core.engine import from_variant as t_variant
from repro_torch.models.layers import Ctx as TCtx
from repro_torch.models.transformer import FAMILIES, Model as TModel
from repro_torch.models.transformer import params_from_jax
from repro_torch.numerics import NumericsContext as TN

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=2e-3)
BACKENDS = {"lax_ref": ("lax_ref", "lax_ref"), "cuda": ("pallas", "cuda")}
NEW_DENSE = ("yi-6b", "nemotron-4-15b", "gemma2-27b", "musicgen-large",
             "chameleon-34b")


def _nctx(backend):
    jb, tb = BACKENDS[backend]
    return (JN.from_ecfg(j_variant(16, "L-21b"), backend=jb),
            TN.from_ecfg(t_variant(16, "L-21b"), backend=tb))


@pytest.fixture(scope="module")
def weights():
    """Each new non-MoE SMOKE model's JAX init and its port conversion."""
    out = {}
    for arch in NEW_DENSE:
        cfg = JC.get_config(arch).SMOKE
        jp = JModel(cfg, remat=False).init(jax.random.PRNGKey(0))
        out[arch] = (jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                         TC.get_config(arch).SMOKE,
                                         device="cpu"))
    return out


def test_registry_matches_reference():
    assert TC.ARCHS == JC.ARCHS
    assert TC.ALIASES == JC.ALIASES
    assert TC.SHAPES == JC.SHAPES
    assert list(TC.all_cells()) == list(JC.all_cells())
    for arch in JC.ALIASES:
        for shape in JC.SHAPES:
            assert (TC.shape_applicable(arch, shape)
                    == JC.shape_applicable(arch, shape))
    assert set(FAMILIES) == {"dense", "moe", "ssm", "hybrid", "audio", "vlm"}
    with pytest.raises(KeyError, match="unknown arch"):
        TC.get_config("gpt-5")


@pytest.mark.parametrize("arch", list(JC.ALIASES))
def test_config_matches_reference_and_assignment(arch):
    """Each FULL config equals its ``EXPECTED`` numbers (as
    ``tests/test_configs.py`` asserts them), and FULL, SMOKE and EXPECTED
    equal the reference module's field by field."""
    tm, jm = TC.get_config(arch), JC.get_config(arch)
    for k, v in tm.EXPECTED.items():
        assert getattr(tm.FULL, k) == v, (arch, k)
    assert tm.EXPECTED == jm.EXPECTED
    assert tm.SMOKE.family == tm.FULL.family
    for which in ("FULL", "SMOKE"):
        t, j = getattr(tm, which), getattr(jm, which)
        assert vars(t) == vars(j), (arch, which)
    assert tm.__doc__ == jm.__doc__


@pytest.mark.parametrize("arch", list(JC.ALIASES))
def test_init_shapes_match_reference(arch):
    """``Model.init`` of every SMOKE config: the same leaves (paths, per-layer
    shapes, parameter count) as the reference's."""
    jcfg, tcfg = JC.get_config(arch).SMOKE, TC.get_config(arch).SMOKE
    jm = JModel(jcfg, remat=False)
    jshapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tp = TModel(tcfg, device="cpu").init(0)
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(jshapes):
        keys = tuple(p.key for p in path)
        shape = leaf.shape[1:] if keys[0] == "layers" else leaf.shape
        want[keys] = (tuple(shape), leaf.dtype)
    got = {}

    def walk(node, keys):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, keys + (k,))
        else:
            got[keys] = (tuple(node.shape), node.dtype)

    walk({"embed": tp["embed"], "ln_f": tp["ln_f"]}, ())
    assert len(tp["layers"]) == tcfg.n_layers
    for layer in tp["layers"]:
        walk(layer, ("layers",))
    assert {k: v[0] for k, v in got.items()} == {
        k: v[0] for k, v in want.items()}
    assert all(v[1] == torch.float32 for v in got.values())
    n_j = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jshapes))
    assert TModel.param_count(tp) == n_j


def _check_logits(arch, jp, tp, jn, tn, steps: int = 1):
    """Prefill (16 tokens, batch 2, uint16 cache) and ``steps`` greedy
    decode steps on both packages, JAX's under one jit; the port's decode
    is fed JAX's tokens."""
    jcfg, tcfg = JC.get_config(arch).SMOKE, TC.get_config(arch).SMOKE
    jm = JModel(jcfg, remat=False, numerics=jn)
    tm = TModel(tcfg, numerics=tn, device="cpu")
    ids = np.random.default_rng(7).integers(0, jcfg.vocab, (2, 16)).astype(
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
                            jm.init_cache(2, 24, jnp.uint16))
    tcache = tm.init_cache(2, 24, "uint16")
    tl, tcache = tm.prefill(tp, torch.from_numpy(ids), TCtx(numerics=tn),
                            tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(want[0][0]), **TOL)
    for t, (jl, tok) in enumerate(want[1:]):
        tl, tcache = tm.decode_step(tp, torch.tensor(np.asarray(tok)),
                                    16 + t, tcache, TCtx(numerics=tn))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("backend", ["lax_ref", "cuda"])
@pytest.mark.parametrize("arch", NEW_DENSE)
def test_smoke_logits_match_reference(weights, arch, backend):
    """Prefill and one decode step on the reference engine; prefill (the
    projections at M = 32 through the kernels' plain versions) on the
    kernels' route."""
    _check_logits(arch, *weights[arch], *_nctx(backend),
                  steps=1 if backend == "lax_ref" else 0)


def test_every_reference_family_builds():
    """Every family of the reference builds; an unknown one is refused."""
    for arch in JC.ALIASES:
        TModel(TC.get_config(arch).SMOKE, EulerConfig(mode="exact"),
               device="cpu")
    bad = TC.get_config("yi-6b").SMOKE.replace(family="diffusion")
    with pytest.raises(NotImplementedError, match="diffusion"):
        TModel(bad, device="cpu")

