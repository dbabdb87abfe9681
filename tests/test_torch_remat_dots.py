"""The remat policy ``"dots"`` (JAX's ``dots_with_no_batch_dims_saveable``)
in the port: the outputs of contractions with no batch dimensions are
saved through a selective-checkpoint policy, everything else is
recomputed.

Bars: the L-21b gradients under ``"dots"`` equal the ``"nothing"``
gradients bit for bit (gemma2 SMOKE, mamba2 SMOKE, the reference's
training CFG ``tests/test_training.py:18``); the CFG's against
``jax.grad`` of the JAX model under ``"dots"`` within relative L2 1e-3 per
leaf (``test_torch_grad_parity.py:39``); no marked (no-batch) contraction
is dispatched again in the backward pass under ``"dots"``.
"""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree as T
from repro_torch.configs import gemma2_2b as TG
from repro_torch.configs import mamba2_1p3b as TMa
from repro_torch.core import engine as TE
from repro_torch.data import SyntheticLM
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.transformer import Model as TModel

torch.set_num_threads(1)

CFG = dict(name="tiny", family="dense", n_layers=2, d_model=128, n_heads=4,
           n_kv_heads=2, d_ff=256, vocab=512, loss_chunk=32, q_chunk=64,
           kv_chunk=64)
ARCHS = {"cfg": TConfig(**CFG), "gemma2": TG.SMOKE, "mamba2": TMa.SMOKE}


def _grads(cfg, policy, params, batch):
    m = TModel(cfg, TE.from_variant(16, "L-21b"), remat_policy=policy,
               device="cpu")
    p = T.map(lambda t: t.detach().clone().requires_grad_(True), params)
    loss, _ = m.loss(p, batch, m.make_ctx())
    return loss, torch.autograd.grad(loss, T.leaves(p))


def test_dots_policy_is_accepted():
    m = TModel(ARCHS["cfg"], remat_policy="dots", device="cpu")
    assert m.remat and m.remat_policy == "dots"
    with pytest.raises(ValueError):
        TModel(ARCHS["cfg"], remat_policy="no_such_policy", device="cpu")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_dots_grads_equal_nothing_bit_for_bit(arch):
    cfg = ARCHS[arch]
    params = TModel(cfg, device="cpu").init(0)
    batch = SyntheticLM(vocab=cfg.vocab, seed=3).batch(0, 2, 32)
    l0, g0 = _grads(cfg, "nothing", params, batch)
    l1, g1 = _grads(cfg, "dots", params, batch)
    assert torch.equal(l0, l1)
    assert len(g0) == len(g1)
    for i, (a, b) in enumerate(zip(g0, g1)):
        assert torch.equal(a, b), (arch, i)


class _MarkedDots(TorchDispatchMode):
    """Counts the contractions dispatched while the engine marks a dot
    with no batch dims."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if (func in (torch.ops.aten.bmm.default, torch.ops.aten.mm.default)
                and TE.in_no_batch_dot()):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_backward_recomputes_no_marked_dot_under_dots(policy):
    """The backward pass of the CFG's loss: under "nothing" the blocks'
    projections are dispatched again but the down projection, whose output
    no backward op needs (the non-reentrant recompute stops after the last
    saved tensor); under "dots" none.  The loss chunks' head remats under
    the default policy on either."""
    cfg = ARCHS["cfg"]
    m = TModel(cfg, TE.EulerConfig(mode="exact"), remat_policy=policy,
               device="cpu")
    p = T.map(lambda t: t.requires_grad_(True), m.init(0))
    batch = SyntheticLM(vocab=cfg.vocab, seed=3).batch(0, 2, 64)
    loss, _ = m.loss(p, batch, m.make_ctx())
    with _MarkedDots() as mode:
        torch.autograd.grad(loss, T.leaves(p))
    head = 64 // cfg.loss_chunk          # one head dot a loss chunk
    per_block = 6                        # q, k, v, o, gate, up
    want = head + (cfg.n_layers * per_block if policy == "nothing" else 0)
    assert mode.n == want, (policy, mode.n, want)
