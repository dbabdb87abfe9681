"""The port's train step: its versions of the six tests of
``tests/test_training.py`` (convergence, convergence under L-21b,
grad-accum equivalence, compressed gradients, determinism, metrics), with
their criteria.  ``test_torch_train_launch.py`` holds checkpoints and the
launcher."""
import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.core.engine import EulerConfig, from_variant
from repro_torch.data import SyntheticLM
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Ctx
from repro_torch.models.transformer import Model
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.training import init_state, make_train_step

torch.set_num_threads(1)

# the reference's training CFG (tests/test_training.py:18)
CFG_KW = dict(name="tiny", family="dense", n_layers=2, d_model=128,
              n_heads=4, n_kv_heads=2, d_ff=256, vocab=512, loss_chunk=32,
              q_chunk=64, kv_chunk=64)
CFG = ModelConfig(**CFG_KW)


def _setup(ecfg=None, compress=False, grad_accum=1, lr=3e-3, remat=True):
    m = Model(CFG, ecfg or EulerConfig(mode="exact"), remat=remat,
              device="cpu")
    ctx = Ctx(ecfg=m.ecfg)
    opt = AdamW(lr=cosine_schedule(lr, 20, 500), weight_decay=0.0)
    state = init_state(m, opt, 0, compress=compress)
    step = make_train_step(m, opt, ctx, grad_accum=grad_accum,
                           compress_grads=compress)
    return m, state, step


# ---------------------------------------------------------------------------
# the six tests of tests/test_training.py
# ---------------------------------------------------------------------------

def test_loss_decreases():
    _, state, step = _setup()
    data = SyntheticLM(vocab=CFG.vocab, seed=3)
    first = last = None
    for i in range(50):
        state, out = step(state, data.batch(i, 8, 64))
        if i == 0:
            first = float(out["loss"])
        last = float(out["loss"])
    assert last < first - 0.5, (first, last)


def test_loss_decreases_under_euler_numerics():
    """QAT with the paper's L-21b engine still trains.  Without remat, which
    gives the same gradients bit for bit
    (``test_torch_training.py::test_remat_gives_the_same_grads``) in half
    the time on the CPU."""
    _, state, step = _setup(ecfg=from_variant(16, "L-21b"), remat=False)
    data = SyntheticLM(vocab=CFG.vocab, seed=3)
    losses = []
    for i in range(50):
        state, out = step(state, data.batch(i, 8, 64))
        losses.append(float(out["loss"]))
    assert losses[-1] < losses[0] - 0.5
    assert np.isfinite(losses).all()


def test_grad_accum_equivalence():
    """accum=2 over the same global batch == accum=1 (up to fp assoc)."""
    data = SyntheticLM(vocab=CFG.vocab, seed=5)
    batch = data.batch(0, 8, 64)
    _, s1, step1 = _setup(grad_accum=1)
    _, s2, step2 = _setup(grad_accum=2)
    s1, o1 = step1(s1, batch)
    s2, o2 = step2(s2, batch)
    np.testing.assert_allclose(float(o1["loss"]), float(o2["loss"]),
                               rtol=1e-5)
    for a, b in zip(T.leaves(s1.params), T.leaves(s2.params), strict=True):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=5e-4, atol=5e-5)


def test_compressed_grads_converge():
    _, state, step = _setup(compress=True)
    data = SyntheticLM(vocab=CFG.vocab, seed=3)
    losses = []
    for i in range(50):
        state, out = step(state, data.batch(i, 8, 64))
        losses.append(float(out["loss"]))
    assert losses[-1] < losses[0] - 0.4
    # EF residual is being used (non-zero)
    ef_norm = sum(float(e.abs().sum()) for e in T.leaves(state.ef))
    assert ef_norm > 0


def test_training_is_deterministic():
    """Same seed + steps => bit-identical params (the replay contract)."""
    data = SyntheticLM(vocab=CFG.vocab, seed=9)
    params = []
    for _ in range(2):
        _, state, step = _setup()
        for i in range(5):
            state, _ = step(state, data.batch(i, 4, 64))
        params.append(T.leaves(state.params))
    for a, b in zip(*params, strict=True):
        assert torch.equal(a, b)


def test_grad_norm_and_lr_reported():
    _, state, step = _setup()
    data = SyntheticLM(vocab=CFG.vocab, seed=3)
    state, out = step(state, data.batch(0, 4, 64))
    assert "grad_norm" in out and float(out["grad_norm"]) > 0
    assert "lr" in out and 0 < float(out["lr"]) <= 3e-3
    assert int(state.step) == 1 and int(state.opt["count"]) == 1
