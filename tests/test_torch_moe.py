"""The port's mixture of experts against the JAX reference
(``repro.models.layers.moe_apply`` on one device): the router's choices,
the capacity and the drop mask exactly, ``moe_apply`` and its aux loss,
the moe trees through ``params_from_jax``, the llama4-scout and arctic
SMOKE logits, ``Model.loss`` with the aux term, and the MoE block's L-21b
gradients.

Bars, stated before the first run: router ids, capacity, ranks and keep
mask equal; outputs, aux and logits within rtol 1e-4 / atol 2e-3
(``tests/test_numerics.py:279``); gradients within relative L2 1e-3 per
leaf of ``jax.grad`` (``test_torch_grad_parity.py``).  The schedule is the
same on both sides: capacity couples the tokens of one call (ROADMAP
queue 3), so nothing here asserts a token's output independent of its
neighbours.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import arctic_480b as JA
from repro.configs import llama4_scout_17b_a16e as JL
from repro.core import engine as JE
from repro.data import SyntheticLM as JData
from repro.models import layers as JLy
from repro.models.layers import Ctx as JCtx
from repro.models.transformer import Model as JModel
from repro_torch import tree as T
from repro_torch.configs import arctic_480b as TA
from repro_torch.configs import llama4_scout_17b_a16e as TL
from repro_torch.core import engine as TE
from repro_torch.models import layers as TLy
from repro_torch.models.layers import Ctx as TCtx
from repro_torch.models.transformer import Model as TModel
from repro_torch.models.transformer import params_from_jax
from test_torch_families import TOL, _nctx

torch.set_num_threads(1)

ARCHS = {"llama4-scout-17b-a16e": (JL.SMOKE, TL.SMOKE),
         "arctic-480b": (JA.SMOKE, TA.SMOKE)}
GRAD_REL_L2 = 1e-3


@pytest.fixture(scope="module")
def moe_weights():
    """One MoE block's parameters per config (JAX's init) and tokens
    [2, 16, d] at the scale of a normed residual."""
    out = {}
    for name, (jc, tc) in ARCHS.items():
        p = JLy.moe_init(jax.random.PRNGKey(1), jc)
        x = np.random.default_rng(0).standard_normal(
            (2, 16, jc.d_model)).astype(np.float32)
        out[name] = (p, _torch_tree(p), x)
    return out


def _torch_tree(p):
    if isinstance(p, dict):
        return {k: _torch_tree(v) for k, v in p.items()}
    return torch.from_numpy(np.array(p))


def _reference_dispatch(xt, w, k, cap):
    """The reference's router and dispatch lines (``moe_apply`` and
    ``_moe_expert_block`` with one device), in JAX."""
    logits = jnp.asarray(xt, jnp.float32) @ jnp.asarray(w)
    _, ids = jax.lax.top_k(jax.nn.softmax(logits, -1), k)
    E = w.shape[1]
    flat_e = ids.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, E + 1, dtype=jnp.int32)
    rank = (jnp.cumsum(onehot, 0) - 1)[jnp.arange(flat_e.shape[0]), flat_e]
    return np.asarray(ids), np.asarray(rank), np.asarray(rank < cap)


@pytest.mark.parametrize("n_tok,k,E,factor", [
    (32, 1, 16, 1.25), (8, 1, 16, 1.25), (4, 1, 16, 1.25), (2, 1, 16, 1.25),
    (32, 1, 4, 1.25), (32, 2, 8, 1.25), (6, 2, 8, 1.0), (1, 1, 128, 1.25),
    (4096, 2, 128, 1.25)])
def test_capacity_rounds_half_to_even(n_tok, k, E, factor):
    want = int(max(1, round(n_tok / 1 * k / E * factor)))
    assert TLy.moe_capacity(n_tok, k, E, factor) == want
    if (n_tok, k, E) == (32, 1, 16):
        assert want == 2          # 2.5 rounds to 2, not 3


@pytest.mark.parametrize("n_tok", [32, 96])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_router_and_drop_mask_match_reference(moe_weights, arch, n_tok):
    """ids, capacity, ranks and the keep mask equal the reference's; at 96
    tokens a quarter-scaled capacity drops tokens on both sides alike."""
    jc, tc = ARCHS[arch]
    p, tp, _ = moe_weights[arch]
    xt = np.random.default_rng(n_tok).standard_normal(
        (n_tok, jc.d_model)).astype(np.float32)
    factor = jc.capacity_factor if n_tok == 32 else 0.25
    cap = TLy.moe_capacity(n_tok, tc.top_k, tc.n_experts, factor)
    assert cap == int(max(1, round(n_tok * jc.top_k / jc.n_experts * factor)))
    ids, rank, keep = _reference_dispatch(xt, p["router"]["w"], jc.top_k,
                                          cap)
    _, _, tids = TLy.moe_route(torch.from_numpy(xt), tp["router"]["w"],
                               tc.top_k)
    flat_e, trank, tkeep = TLy.moe_dispatch(tids, tc.n_experts, cap)
    np.testing.assert_array_equal(tids.numpy(), ids)
    np.testing.assert_array_equal(flat_e.numpy(), ids.reshape(-1))
    np.testing.assert_array_equal(trank.numpy(), rank)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    if n_tok == 96:
        assert not keep.all()     # the drop path runs


@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_ties_take_the_lower_expert(k):
    """Equal probabilities go to the lower expert id first, as
    ``lax.top_k``: a zero router (every expert tied) and a router tying
    experts 2 and 5 above the rest."""
    xt = torch.randn(5, 8, generator=torch.Generator().manual_seed(0))
    w_tie = torch.zeros(8, 6)
    w_tie[0, 2] = w_tie[0, 5] = 1.0
    xt_tie = torch.zeros(5, 8)
    xt_tie[:, 0] = 2.0
    for x, w in ((xt, torch.zeros(8, 6)), (xt_tie, w_tie)):
        _, _, ids = TLy.moe_route(x, w, k)
        _, jids = jax.lax.top_k(jax.nn.softmax(
            jnp.asarray(x.numpy()) @ jnp.asarray(w.numpy()), -1), k)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


@pytest.mark.parametrize("backend", ["exact", "lax_ref", "cuda"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_moe_apply_matches_reference(moe_weights, arch, backend):
    """The block's output and aux loss (JAX's under jit); arctic adds its
    dense residual MLP, whose one contraction is the kernels' route under
    ``cuda``."""
    jc, tc = ARCHS[arch]
    p, tp, x = moe_weights[arch]
    if backend == "exact":
        jn, tn = (JE.from_variant(16, "L-21b").replace(mode="exact"),
                  TE.EulerConfig(mode="exact"))
        jctx, tctx = JCtx(ecfg=jn), TCtx(ecfg=tn)
    else:
        jn, tn = _nctx(backend)
        jctx, tctx = JCtx(numerics=jn), TCtx(numerics=tn)
    jy, jaux = jax.jit(lambda p, x: JLy.moe_apply(p, x, jctx, jc))(
        p, jnp.asarray(x))
    ty, taux = TLy.moe_apply(tp, torch.from_numpy(x), tctx, tc)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)


def test_moe_trees_convert_from_jax():
    """``params_from_jax`` on the moe trees: the router [d, E], the
    experts' ``wi``/``wg``/``wo`` as [E, ...] per layer and arctic's dense
    residual MLP, values unchanged."""
    for name, (jc, tc) in ARCHS.items():
        jp = JModel(jc, remat=False).init(jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
        assert len(tp["layers"]) == tc.n_layers
        for i, layer in enumerate(tp["layers"]):
            moe = layer["moe"]
            E, d, f = tc.n_experts, tc.d_model, tc.d_ff
            assert tuple(moe["router"]["w"].shape) == (d, E)
            assert tuple(moe["wi"]["w"].shape) == (E, d, f)
            assert tuple(moe["wg"]["w"].shape) == (E, d, f)
            assert tuple(moe["wo"]["w"].shape) == (E, f, d)
            assert ("dense" in moe) == tc.moe_dense_residual
            assert "mlp" not in layer and "ln2" in layer
            jl = jax.tree.map(lambda a: np.asarray(a)[i], jp["layers"])
            for (path, leaf), t in zip(
                    jax.tree_util.tree_leaves_with_path(jl), T.leaves(layer)):
                np.testing.assert_array_equal(t.numpy(), leaf,
                                              err_msg=str(path))


@pytest.fixture(scope="module")
def model_weights():
    out = {}
    for name, (jc, tc) in ARCHS.items():
        jp = JModel(jc, remat=False).init(jax.random.PRNGKey(0))
        out[name] = (jp, params_from_jax(jax.tree.map(np.asarray, jp), tc,
                                         device="cpu"))
    return out


@pytest.mark.parametrize("backend", ["lax_ref", "cuda"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_smoke_logits_match_reference(model_weights, arch, backend):
    """Prefill (2 x 16 tokens: capacity over 32) and one decode step (2
    tokens) on the reference engine, prefill on the kernels' route (the
    expert contractions are batched: the reference engine on both)."""
    from test_torch_families import _check_logits
    _check_logits(arch, *model_weights[arch], *_nctx(backend),
                  steps=1 if backend == "lax_ref" else 0)


def _batch(jc):
    return {k: np.asarray(v)
            for k, v in JData(vocab=jc.vocab, seed=3).batch(0, 2, 64).items()}


def test_loss_with_aux_matches_reference(model_weights):
    """``Model.loss`` of llama4-smoke under L-21b: xent, the aux summed
    over both blocks, and the loss ``xent + 0.01 aux``."""
    jc, tc = ARCHS["llama4-scout-17b-a16e"]
    jp, tp = model_weights["llama4-scout-17b-a16e"]
    b = _batch(jc)
    jm = JModel(jc, JE.from_variant(16, "L-21b"), remat=False)
    jl, jmet = jax.jit(lambda p: jm.loss(p, b, jm.make_ctx()))(jp)
    tm = TModel(tc, TE.from_variant(16, "L-21b"), remat=False, device="cpu")
    with torch.no_grad():
        tl, tmet = tm.loss(tp, {k: torch.from_numpy(v.astype(np.int64))
                                for k, v in b.items()}, tm.make_ctx())
    for got, want in ((tl, jl), (tmet["xent"], jmet["xent"]),
                      (tmet["aux"], jmet["aux"])):
        np.testing.assert_allclose(float(got), float(want), **TOL)
    assert float(tmet["aux"]) > 0
    assert float(tl) == float(tmet["xent"] + 0.01 * tmet["aux"])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_moe_block_l21b_grads_match_jax(moe_weights, arch):
    """The MoE block's L-21b gradients (its parameters and its input, under
    a fixed random cotangent, the aux loss added) against ``jax.grad``,
    per leaf.  The whole llama4-smoke model misses this bar at one leaf
    (ROADMAP queue 3), as gemma2 SMOKE does: held block by block here."""
    jc, tc = ARCHS[arch]
    p, _, x = moe_weights[arch]
    r = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    jctx = JCtx(ecfg=JE.from_variant(16, "L-21b"))

    def jloss(p, x):
        y, aux = JLy.moe_apply(p, x, jctx, jc)
        return jnp.sum(y * r) + aux

    want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(p, jnp.asarray(x))
    want = [np.asarray(w) for w in jax.tree.leaves(want)]
    tp = T.map(lambda a: a.clone().requires_grad_(True), _torch_tree(p))
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = TLy.moe_apply(tp, tx, TCtx(ecfg=TE.from_variant(16, "L-21b")),
                           tc)
    got = torch.autograd.grad(torch.sum(y * torch.from_numpy(r)) + aux,
                              T.leaves(tp) + [tx])
    assert len(got) == len(want)
    for i, (gl, wl) in enumerate(zip(got, want)):
        w = torch.from_numpy(np.array(wl)).double()
        err = float((gl.double() - w).norm() / w.norm())
        assert err <= GRAD_REL_L2, (arch, i, tuple(w.shape), err)
