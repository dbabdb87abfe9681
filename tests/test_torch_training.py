"""The port's ``Model.loss`` and its gradients against the JAX reference:
the loss of gemma2 SMOKE, mamba2 SMOKE and the 4-layer hybrid on the exact
engine and under L-21b, ``jax.grad`` of the loss on the exact engine, and
remat (``test_torch_ste.py`` holds the straight-through gradients under
L-21b, ``test_torch_train_loop.py`` the train step).

Bars, stated before the first run:
  * loss: rtol 1e-4, atol 2e-3 (the model-logits bar,
    ``tests/test_numerics.py:279``);
  * gradients on the exact engine: each leaf within rtol 1e-4, atol 1e-6.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import gemma2_2b as JG
from repro.configs import mamba2_1p3b as JMa
from repro.core import engine as JE
from repro.data import SyntheticLM as JData
from repro.models.config import ModelConfig as JConfig
from repro.models.transformer import Model as JModel
from repro_torch import tree as T
from repro_torch.configs import gemma2_2b as TG
from repro_torch.configs import mamba2_1p3b as TMa
from repro_torch.core import engine as TE
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.transformer import Model as TModel, params_from_jax

torch.set_num_threads(1)

LOSS_TOL = dict(rtol=1e-4, atol=2e-3)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)

# the reference's training CFG (tests/test_training.py:18)
CFG = dict(name="tiny", family="dense", n_layers=2, d_model=128, n_heads=4,
           n_kv_heads=2, d_ff=256, vocab=512, loss_chunk=32, q_chunk=64,
           kv_chunk=64)
# the 4-layer hybrid of test_torch_ssm.py (layer 1 local, window 8)
LOCAL_HYBRID = dict(name="hyb-local", family="hybrid", n_layers=4,
                    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                    d_ff=128, vocab=256, ssm_state=8, ssm_head_dim=16,
                    ssm_chunk=8, n_global_layers=1, window=8,
                    loss_chunk=32, q_chunk=16, kv_chunk=16)
ARCHS = {"cfg": (JConfig(**CFG), TConfig(**CFG)),
         "gemma2": (JG.SMOKE, TG.SMOKE),
         "mamba2": (JMa.SMOKE, TMa.SMOKE),
         "hybrid-local": (JConfig(**LOCAL_HYBRID), TConfig(**LOCAL_HYBRID))}
MODES = ("exact", "L-21b")


def _ecfgs(mode):
    if mode == "exact":
        return JE.EulerConfig(mode="exact"), TE.EulerConfig(mode="exact")
    return JE.from_variant(16, "L-21b"), TE.from_variant(16, "L-21b")


def _trainable(params):
    return T.map(lambda p: p.detach().clone().requires_grad_(True), params)


@pytest.fixture(scope="module")
def setups():
    """{arch: (jax params, port params, batch as numpy)}, one seed."""
    out = {}
    for name, (jc, tc) in ARCHS.items():
        jp = JModel(jc).init(jax.random.PRNGKey(0))
        b = JData(vocab=jc.vocab, seed=3).batch(0, 2, 64)
        out[name] = (jp, params_from_jax(jax.tree.map(np.asarray, jp), tc,
                                         device="cpu"),
                     {k: np.asarray(v) for k, v in b.items()})
    return out


def _torch_batch(b):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()}


def _jax_loss_and_grads(arch, mode, jp, b):
    jc, _ = ARCHS[arch]
    je, _ = _ecfgs(mode)
    jm = JModel(jc, je)
    fn = jax.value_and_grad(lambda p: jm.loss(p, b, jm.make_ctx()),
                            has_aux=True)
    (loss, metrics), g = jax.jit(fn)(jp)
    return float(loss), metrics, params_from_jax(jax.tree.map(np.asarray, g),
                                                 jc, device="cpu")


def _port_loss_and_grads(arch, mode, tp, b, remat=True):
    _, tc = ARCHS[arch]
    _, te = _ecfgs(mode)
    tm = TModel(tc, te, remat=remat, device="cpu")
    tp = _trainable(tp)
    loss, metrics = tm.loss(tp, _torch_batch(b), tm.make_ctx())
    grads = torch.autograd.grad(loss, T.leaves(tp))
    return float(loss.detach()), metrics, grads


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ["gemma2", "mamba2", "hybrid-local"])
def test_loss_matches_reference(setups, arch, mode):
    jp, tp, b = setups[arch]
    jc, tc = ARCHS[arch]
    je, te = _ecfgs(mode)
    jm = JModel(jc, je)
    want, wm = jax.jit(lambda p: jm.loss(p, b, jm.make_ctx()))(jp)
    tm = TModel(tc, te, device="cpu")
    with torch.no_grad():
        got, gm = tm.loss(tp, _torch_batch(b), tm.make_ctx())
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
    np.testing.assert_allclose(float(gm["xent"]), float(wm["xent"]),
                               **LOSS_TOL)
    assert float(gm["aux"]) == float(wm["aux"]) == 0.0


def test_loss_chunks_must_divide():
    tm = TModel(TConfig(**CFG), device="cpu")
    params = tm.init(0)
    ids = torch.zeros((1, 48), dtype=torch.int64)
    with pytest.raises(ValueError, match="loss chunk"):
        tm.loss(params, {"inputs": ids, "labels": ids}, tm.make_ctx())


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(ARCHS))
def test_exact_grads_match_reference(setups, arch):
    """``jax.grad`` of the loss on the exact engine, leaf by leaf."""
    jp, tp, b = setups[arch]
    want_loss, _, want = _jax_loss_and_grads(arch, "exact", jp, b)
    got_loss, _, got = _port_loss_and_grads(arch, "exact", tp, b)
    np.testing.assert_allclose(got_loss, want_loss, **LOSS_TOL)
    for w, g in zip(T.leaves(want), got, strict=True):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL)


@pytest.mark.parametrize("arch", ["cfg", "hybrid-local"])
def test_remat_gives_the_same_grads(setups, arch):
    """Rematerialized blocks and loss chunks recompute the same forward:
    bit-identical loss and gradients."""
    _, tp, b = setups[arch]
    l1, _, g1 = _port_loss_and_grads(arch, "L-21b", tp, b, remat=True)
    l0, _, g0 = _port_loss_and_grads(arch, "L-21b", tp, b, remat=False)
    assert l1 == l0
    for x, y in zip(g1, g0, strict=True):
        assert torch.equal(x, y)


def test_remat_policies():
    cfg = TConfig(**CFG)
    assert TModel(cfg, device="cpu").remat
    assert TModel(cfg, remat_policy="none", device="cpu").remat
    assert not TModel(cfg, remat_policy="everything", device="cpu").remat
    dots = TModel(cfg, remat_policy="dots", device="cpu")
    assert dots.remat and dots.remat_policy == "dots"
    with pytest.raises(ValueError, match="unknown remat policy"):
        TModel(cfg, remat_policy="some", device="cpu")
