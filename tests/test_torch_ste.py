"""Straight-through (STE) gradients of the port against ``jax.grad`` under
EULER numerics, and the ``cuda`` backend in training: ``euler_dot_general``
in every mode (plain and batched contractions, fused planes, out_quant,
no pre-scale), each block kind under L-21b (MLP, attention, the SSM
mixer), the ``cuda`` backend's refusal under autograd, and the eval step
on the kernels' plain versions against the reference engine.

Bars, stated before the first run:
  * the engine's gradients: rtol 1e-4, atol 1e-6 (each is a contraction of
    the other operand's planes: the gradient bar of the exact engine);
  * a block's gradients under L-21b: each leaf's relative L2 error at
    most 1e-3.
A whole model's L-21b gradients miss that bar: torch's float32 elementwise
functions (exp, rsqrt, silu, tanh) round differently from XLA's in the
last bit, and under L-21b such a difference moves a quantized operand
across a rounding boundary; on the reference's training CFG the gradients
differ by 1.24e-3 (ROADMAP queue 3).  So they are held block by block, on
the same inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.data import SyntheticLM as JData
from repro.models import layers as JL
from repro.models import ssm as JS
from repro.models.config import ModelConfig as JConfig
from repro.models.transformer import Model as JModel
from repro_torch import tree as T
from repro_torch.core import engine as TE
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.transformer import Model as TModel, params_from_jax
from repro_torch.numerics import NumericsContext as TN
from repro_torch.optim import AdamW
from repro_torch.training import init_state, make_eval_step, make_train_step

torch.set_num_threads(1)

GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
L21B_REL_L2 = 1e-3

# the reference's training CFG (tests/test_training.py:18)
CFG = dict(name="tiny", family="dense", n_layers=2, d_model=128, n_heads=4,
           n_kv_heads=2, d_ff=256, vocab=512, loss_chunk=32, q_chunk=64,
           kv_chunk=64)
# the 4-layer hybrid of test_torch_ssm.py: the blocks' shapes
LOCAL_HYBRID = dict(name="hyb-local", family="hybrid", n_layers=4,
                    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                    d_ff=128, vocab=256, ssm_state=8, ssm_head_dim=16,
                    ssm_chunk=8, n_global_layers=1, window=8,
                    loss_chunk=32, q_chunk=16, kv_chunk=16)


def _trainable(params):
    return T.map(lambda p: p.detach().clone().requires_grad_(True), params)


@pytest.fixture(scope="module")
def cfg_setup():
    """(port params, batch) of the training CFG from the JAX init."""
    jp = JModel(JConfig(**CFG)).init(jax.random.PRNGKey(0))
    b = JData(vocab=CFG["vocab"], seed=3).batch(0, 2, 64)
    return (params_from_jax(jax.tree.map(np.asarray, jp), TConfig(**CFG),
                            device="cpu"),
            {k: torch.from_numpy(np.asarray(v).astype(np.int64))
             for k, v in b.items()})


def _block_case(block):
    """(jax fn, port fn, inputs as numpy) of one block under L-21b: the
    sum of its output weighted by a fixed random tensor."""
    rng = np.random.default_rng(11)
    je, te = JE.from_variant(16, "L-21b"), TE.from_variant(16, "L-21b")
    jcfg, tcfg = JConfig(**LOCAL_HYBRID), TConfig(**LOCAL_HYBRID)
    x = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    if block == "mlp":
        jp = JL.mlp_init(key, jcfg)

        def jf(p, x):
            return JL.mlp_apply(p, x, JL.Ctx(ecfg=je), jcfg.mlp)

        def tf(p, x):
            return TL.mlp_apply(p, x, TL.Ctx(ecfg=te), tcfg.mlp)
    elif block == "attention":
        jp = JL.attention_init(key, jcfg)
        pos = np.arange(16, dtype=np.int32)

        def jf(p, x):
            return JL.attention_apply(p, x, JL.Ctx(ecfg=je), jcfg, 8,
                                      jnp.asarray(pos), q_chunk=8,
                                      kv_chunk=8)[0]

        def tf(p, x):
            return TL.attention_apply(p, x, TL.Ctx(ecfg=te), tcfg, 8,
                                      torch.from_numpy(pos), q_chunk=8,
                                      kv_chunk=8)[0]
    else:
        jp = JS.ssm_init(key, jcfg)

        def jf(p, x):
            return JS.ssm_apply(p, x, JL.Ctx(ecfg=je), jcfg)[0]

        def tf(p, x):
            return TS.ssm_apply(p, x, TL.Ctx(ecfg=te), tcfg)[0]
    return jf, tf, jax.tree.map(np.asarray, jp), x, w


@pytest.mark.parametrize("block", ["mlp", "attention", "ssm"])
def test_block_grads_under_l21b_match_reference(block):
    jf, tf, params, x, w = _block_case(block)
    want = jax.jit(jax.grad(
        lambda p, x: jnp.sum(jf(p, x) * w), argnums=(0, 1)))(params,
                                                             jnp.asarray(x))
    tp = T.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(True),
               params)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = torch.sum(tf(tp, tx) * torch.from_numpy(w))
    got = torch.autograd.grad(out, T.leaves(tp) + [tx])
    wants = jax.tree.leaves(want[0]) + [want[1]]
    for wv, g in zip(wants, got, strict=True):
        wv = torch.from_numpy(np.array(wv))
        assert float((g - wv).norm() / wv.norm()) <= L21B_REL_L2


STE_CASES = {"exact": dict(mode="exact"), "posit": dict(mode="posit"),
             "euler": {}, "euler-fused": dict(fuse_planes=True),
             "euler-out-quant": dict(out_quant=True),
             "euler-no-pre-scale": dict(pre_scale=False)}


@pytest.mark.parametrize("case", list(STE_CASES))
@pytest.mark.parametrize("dn", [
    (((1,), (0,)), ((), ())),                      # a @ b
    (((2,), (2,)), ((0,), (0,))),                  # batched, as the SSD's
])
def test_engine_ste_grads_match_reference(case, dn):
    """``euler_dot_general``'s straight-through gradients against
    ``jax.grad`` through ``repro.core.engine``."""
    rng = np.random.default_rng(2)
    if dn[1][0]:
        a = rng.standard_normal((3, 8, 24)).astype(np.float32)
        b = rng.standard_normal((3, 6, 24)).astype(np.float32) * 0.1
        w = rng.standard_normal((3, 8, 6)).astype(np.float32)
    else:
        a = rng.standard_normal((16, 40)).astype(np.float32)
        b = rng.standard_normal((40, 12)).astype(np.float32) * 0.1
        w = rng.standard_normal((16, 12)).astype(np.float32)
    jc = JE.from_variant(16, "L-21b", **STE_CASES[case])
    tc = TE.from_variant(16, "L-21b", **STE_CASES[case])
    want = jax.jit(jax.grad(lambda x, y: jnp.sum(
        JE.euler_dot_general(x, y, dn, jc) * w), argnums=(0, 1)))(a, b)
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    out = torch.sum(TE.euler_dot_general(ta, tb, dn, tc)
                    * torch.from_numpy(w))
    got = torch.autograd.grad(out, (ta, tb))
    for wv, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), **GRAD_TOL)


# ---------------------------------------------------------------------------
# the cuda backend and the eval step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["cuda", "guarded:cuda", "faulty:cuda"])
def test_cuda_backend_refuses_autograd(cfg_setup, backend):
    """The kernels have no backward: a train step on ``cuda`` would leave
    the weights without gradients, so it raises and names ``lax_ref``."""
    _, b = cfg_setup
    nctx = TN.from_ecfg(TE.from_variant(16, "L-21b"), backend=backend)
    tm = TModel(TConfig(**CFG), numerics=nctx, device="cpu")
    opt = AdamW(lr=1e-3)
    state = init_state(tm, opt, 0)
    step = make_train_step(tm, opt, tm.make_ctx())
    with pytest.raises(RuntimeError, match="lax_ref"):
        step(state, b)


def test_eval_step_cuda_matches_lax_ref(cfg_setup):
    """The eval step on the ``cuda`` backend (here the kernels' plain
    versions) against the reference engine, called with parameters that
    require grad and autograd on (the step turns it off itself): within
    2 (2e-3 + 1e-4 max|logit|), the logits bar carried through the mean
    log-softmax."""
    tp, b = cfg_setup
    cfg = TConfig(**CFG)
    losses, maxlogit = {}, 0.0
    params = _trainable(tp)
    assert torch.is_grad_enabled()
    assert all(p.requires_grad for p in T.leaves(params))
    for backend in ("cuda", "lax_ref"):
        nctx = TN.from_ecfg(TE.from_variant(16, "L-21b"), backend=backend)
        tm = TModel(cfg, numerics=nctx, device="cpu")
        out = make_eval_step(tm, tm.make_ctx())(params, b)
        assert not out["loss"].requires_grad
        losses[backend] = float(out["loss"])
        with torch.no_grad():
            if backend == "lax_ref":
                hidden, _ = tm.forward(tp, b["inputs"],
                                       tm.make_ctx())
                maxlogit = float(tm.head(tp, hidden, tm.make_ctx())[
                    ..., :cfg.vocab].abs().max())
    bound = 2 * (2e-3 + 1e-4 * maxlogit)
    assert abs(losses["cuda"] - losses["lax_ref"]) <= bound
