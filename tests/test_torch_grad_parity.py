"""Whole-model L-21b gradients of the port against ``jax.grad``, and the
float32 elementwise functions that bring them there
(``repro_torch/core/xla_f32.py``: XLA:CPU's roundings on CPU tensors).

Bars, stated before the first run:
  * whole-model gradients under L-21b: each leaf within relative L2 1e-3
    of ``jax.grad``'s (ROADMAP queue 3), on the reference's training CFG
    (``tests/test_training.py:18``, batch 2 x 64) and mamba2 SMOKE, with
    the JAX model's weights converted by ``params_from_jax``.  gemma2 SMOKE
    (1.06e-3) and the 4-layer hybrid (1.91e-3) still miss it and have no
    test here: their remaining error and its sources are in ROADMAP queue 3
    (JAX's own eager run differs from its jit run by 1.19e-3 and 5.43e-3
    there; run this file as a script for these numbers); the CFG also
    under remat policy "dots" against JAX's "dots";
  * each transcribed function: XLA's bits exactly, forward and vjp, on
    2^16 values (the model's range and random bit patterns); rsqrt, which
    refines the host CPU's ``rsqrtps`` table and is not transcribed, within
    one ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_1p3b as JMa
from repro.core import engine as JE
from repro.data import SyntheticLM as JData
from repro.models.config import ModelConfig as JConfig
from repro.models.transformer import Model as JModel
from repro_torch import tree as T
from repro_torch.configs import mamba2_1p3b as TMa
from repro_torch.core import engine as TE
from repro_torch.core import xla_f32 as X
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.transformer import Model as TModel, params_from_jax

torch.set_num_threads(1)

GRAD_REL_L2 = 1e-3

# the reference's training CFG (tests/test_training.py:18)
CFG = dict(name="tiny", family="dense", n_layers=2, d_model=128, n_heads=4,
           n_kv_heads=2, d_ff=256, vocab=512, loss_chunk=32, q_chunk=64,
           kv_chunk=64)
ARCHS = {"cfg": (JConfig(**CFG), TConfig(**CFG)),
         "mamba2": (JMa.SMOKE, TMa.SMOKE)}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_whole_model_l21b_grads_match_jax(arch):
    jc, tc = ARCHS[arch]
    jp = JModel(jc).init(jax.random.PRNGKey(0))
    b = {k: np.asarray(v)
         for k, v in JData(vocab=jc.vocab, seed=3).batch(0, 2, 64).items()}
    jm = JModel(jc, JE.from_variant(16, "L-21b"))
    fn = jax.value_and_grad(lambda p: jm.loss(p, b, jm.make_ctx()),
                            has_aux=True)
    (_, _), g = jax.jit(fn)(jp)
    want = T.leaves(params_from_jax(jax.tree.map(np.asarray, g), jc,
                                    device="cpu"))
    tm = TModel(tc, TE.from_variant(16, "L-21b"), remat=False, device="cpu")
    tp = T.map(lambda p: p.detach().clone().requires_grad_(True),
               params_from_jax(jax.tree.map(np.asarray, jp), tc,
                               device="cpu"))
    loss, _ = tm.loss(tp, {k: torch.from_numpy(v.astype(np.int64))
                           for k, v in b.items()}, tm.make_ctx())
    got = torch.autograd.grad(loss, T.leaves(tp))
    assert len(got) == len(want)
    for i, (gl, wl) in enumerate(zip(got, want)):
        w = wl.double()
        err = float((gl.double() - w).norm() / w.norm())
        assert err <= GRAD_REL_L2, (arch, i, tuple(w.shape), err)


def test_cfg_l21b_grads_under_dots_remat_match_jax():
    """The CFG under remat policy "dots" (the port saves the no-batch
    contractions' outputs through a selective-checkpoint policy) against
    ``jax.grad`` of the JAX model under "dots"."""
    jc = JConfig(**CFG)
    jp = JModel(jc).init(jax.random.PRNGKey(0))
    b = {k: np.asarray(v)
         for k, v in JData(vocab=jc.vocab, seed=3).batch(0, 2, 64).items()}
    jm = JModel(jc, JE.from_variant(16, "L-21b"), remat_policy="dots")
    _, g = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, b, jm.make_ctx()), has_aux=True))(jp)
    want = T.leaves(params_from_jax(jax.tree.map(np.asarray, g), jc,
                                    device="cpu"))
    tc = ARCHS["cfg"][1]
    tm = TModel(tc, TE.from_variant(16, "L-21b"), remat_policy="dots",
                device="cpu")
    tp = T.map(lambda p: p.detach().clone().requires_grad_(True),
               params_from_jax(jax.tree.map(np.asarray, jp), tc,
                               device="cpu"))
    loss, _ = tm.loss(tp, {k: torch.from_numpy(v.astype(np.int64))
                           for k, v in b.items()}, tm.make_ctx())
    got = torch.autograd.grad(loss, T.leaves(tp))
    assert len(got) == len(want)
    for i, (gl, wl) in enumerate(zip(got, want)):
        w = wl.double()
        err = float((gl.double() - w).norm() / w.norm())
        assert err <= GRAD_REL_L2, (i, tuple(w.shape), err)


def _inputs(kind: str) -> np.ndarray:
    rng = np.random.default_rng(0)
    n = 1 << 15
    pats = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    rand = pats.view(np.float32)
    rand = rand[np.isfinite(rand)]
    model = np.concatenate([rng.uniform(-30, 30, n // 2),
                            rng.standard_normal(n // 2) * 3])
    x = np.concatenate([model, rand]).astype(np.float32)
    if kind == "positive":
        x = np.abs(x) + np.float32(1e-3)
    return x


def _same_bits(got: np.ndarray, want: np.ndarray) -> float:
    nan = np.isnan(want) & np.isnan(got)
    return float(np.mean((got.view(np.uint32) != want.view(np.uint32))
                         & ~nan))


FUNCS = {
    "exp": (jnp.exp, X.exp, "any"),
    "log": (jnp.log, X.log, "positive"),
    "tanh": (jnp.tanh, X.tanh, "any"),
    "silu": (jax.nn.silu, X.silu, "any"),
    "gelu_tanh": (lambda v: jax.nn.gelu(v, approximate=True), X.gelu_tanh,
                  "any"),
    "softplus": (jax.nn.softplus, X.softplus, "any"),
}


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_function_gives_xla_bits(name):
    """Forward and vjp bit for bit equal to ``jax.jit`` of the function on
    XLA:CPU (a subnormal result flushed to zero, as XLA's kernels do)."""
    jf, tf, kind = FUNCS[name]
    x = _inputs(kind)
    ct = np.random.default_rng(1).standard_normal(x.size).astype(np.float32)
    want = np.asarray(jax.jit(jf)(x))
    want_g = np.asarray(jax.jit(lambda v, c: jax.vjp(jf, v)[1](c)[0])(x, ct))
    t = torch.from_numpy(x).requires_grad_(True)
    out = tf(t)
    out.backward(torch.from_numpy(ct))
    # the vjp is held on the model's range, where the cotangent is finite
    m = np.isfinite(want_g) & (np.abs(x) < 80)
    assert _same_bits(out.detach().numpy(), want) == 0.0
    assert _same_bits(t.grad.numpy()[m], want_g[m]) == 0.0


def test_log1p_gives_xla_bits():
    """log1p (softplus' second half): both branches, XLA's bits."""
    x = np.concatenate([np.random.default_rng(2).uniform(-0.99, 3, 1 << 15),
                        np.linspace(-0.5, 0.5, 4097)]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.log1p)(x))
    assert _same_bits(X.log1p_fwd(torch.from_numpy(x)).numpy(), want) == 0


def test_rsqrt_within_one_ulp():
    """rsqrt is not XLA's bit for bit (XLA refines the CPU's table
    estimate, rsqrtps): within one ulp, and never farther than torch's."""
    x = _inputs("positive")
    x = x[(x > 1e-30) & (x < 1e30)]
    want = np.asarray(jax.jit(jax.lax.rsqrt)(x)).view(np.int32)
    got = X.rsqrt(torch.from_numpy(x)).numpy().view(np.int32)
    assert int(np.abs(got.astype(np.int64) - want).max()) <= 1


@pytest.mark.parametrize("n", [8, 16, 32, 64, 96, 256, 1024, 2048])
def test_sum_and_mean_in_xla_order(n):
    """A row sum as XLA:CPU's tree-reduction rewrite orders it, and the
    mean as that sum times 1/n, with the cotangent times the same 1/n."""
    x = np.random.default_rng(n).standard_normal((64, n)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jnp.sum(v, -1, keepdims=True))(x))
    assert _same_bits(X.sum_last(torch.from_numpy(x)).numpy(), want) == 0
    if n % 32 == 0:
        jf = lambda v: jnp.mean(v, -1, keepdims=True)  # noqa: E731
        want = np.asarray(jax.jit(jf)(x))
        ct = np.random.default_rng(0).standard_normal((64, 1)).astype(
            np.float32)
        want_g = np.asarray(jax.jit(lambda v, c: jax.vjp(jf, v)[1](c)[0])(
            x, ct))
        t = torch.from_numpy(x).requires_grad_(True)
        out = X.mean_last(t)
        out.backward(torch.from_numpy(ct))
        assert _same_bits(out.detach().numpy(), want) == 0
        assert _same_bits(t.grad.numpy(), want_g) == 0


@pytest.mark.parametrize("n", [8, 16])
def test_prefix_sum_in_xla_order(n):
    """The SSD's ``jnp.cumsum`` over a chunk: forward and its transpose
    (the reversed prefix sum) bit for bit."""
    x = (-np.abs(np.random.default_rng(n).standard_normal((4, n, 8)))
         * 0.05).astype(np.float32)
    ct = np.random.default_rng(1).standard_normal(x.shape).astype(
        np.float32)
    jf = lambda v: jnp.cumsum(v, axis=1)  # noqa: E731
    want = np.asarray(jax.jit(jf)(x))
    want_g = np.asarray(jax.jit(lambda v, c: jax.vjp(jf, v)[1](c)[0])(x, ct))
    t = torch.from_numpy(x).requires_grad_(True)
    out = X.prefix_sum(t, 1)
    out.backward(torch.from_numpy(ct))
    assert _same_bits(out.detach().numpy(), want) == 0
    assert _same_bits(t.grad.numpy(), want_g) == 0


def test_helpers_keep_torch_functions_off_the_cpu():
    """On a tensor that is not on the CPU the helpers are torch's own
    functions (checked on the meta device: shapes only, no transcription
    is traced)."""
    x = torch.empty((3, 64), device="meta")
    for fn in (X.exp, X.log, X.tanh, X.silu, X.gelu_tanh, X.softplus,
               X.rsqrt, X.mean_last, X.softmax, X.logsumexp):
        out = fn(x)
        assert out.device.type == "meta"


# --------------------------------------------------------------------------
# run as a script: the measurements behind ROADMAP queue 3's gradient item
#   PYTHONPATH=src python tests/test_torch_grad_parity.py
# --------------------------------------------------------------------------

def _mismatch_table():
    """Per function, the share of values whose bits differ from jax.jit's,
    for the transcription and for torch's own function, over 2^23 random
    f32 bit patterns and 2^22.5 values of the model's range."""
    import torch.nn.functional as F
    rng = np.random.default_rng(0)
    pats = rng.integers(0, 1 << 32, 1 << 23, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    model = np.concatenate([
        rng.uniform(-30, 30, 1 << 22), rng.standard_normal(1 << 22) * 3,
        np.exp(rng.uniform(-80, 80, 1 << 21))
        * rng.choice([-1, 1], 1 << 21)]).astype(np.float32)
    cases = {
        "exp": (jnp.exp, X.exp, torch.exp),
        "sigmoid": (jax.nn.sigmoid, X.logistic_fwd, torch.sigmoid),
        "silu": (jax.nn.silu, X.silu, F.silu),
        "gelu_tanh": (FUNCS["gelu_tanh"][0], X.gelu_tanh,
                      lambda t: F.gelu(t, approximate="tanh")),
        "tanh": (jnp.tanh, X.tanh, torch.tanh),
        "log": (jnp.log, X.log, torch.log),
        "log1p": (jnp.log1p, X.log1p_fwd, torch.log1p),
        "softplus": (jax.nn.softplus, X.softplus, F.softplus),
        "rsqrt": (jax.lax.rsqrt, X.rsqrt, torch.rsqrt)}
    for name, (jf, xf, tf) in cases.items():
        row = []
        for x in (pats, model):
            want = np.asarray(jax.jit(jf)(x))
            with torch.no_grad():
                got = xf(torch.from_numpy(x)).numpy()
                ref = tf(torch.from_numpy(x)).numpy()
            row.append(f"{_same_bits(got, want):.4%} (torch {_same_bits(ref, want):.4%})")
        print(f"{name:10s} bit patterns {row[0]:28s} model range {row[1]}")


def _grad_errors():
    """Per-leaf relative L2 of the port's whole-model L-21b gradients, and
    of JAX's eager run, against jax.jit(jax.grad)."""
    from repro.configs import gemma2_2b as JG
    from repro_torch.configs import gemma2_2b as TG
    hybrid = dict(name="hyb-local", family="hybrid", n_layers=4,
                  d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                  d_ff=128, vocab=256, ssm_state=8, ssm_head_dim=16,
                  ssm_chunk=8, n_global_layers=1, window=8,
                  loss_chunk=32, q_chunk=16, kv_chunk=16)
    from repro.configs import llama4_scout_17b_a16e as JL
    from repro_torch.configs import llama4_scout_17b_a16e as TL
    archs = dict(ARCHS, gemma2=(JG.SMOKE, TG.SMOKE),
                 hybrid=(JConfig(**hybrid), TConfig(**hybrid)),
                 llama4=(JL.SMOKE, TL.SMOKE))
    for arch, (jc, tc) in archs.items():
        jp = JModel(jc).init(jax.random.PRNGKey(0))
        b = {k: np.asarray(v)
             for k, v in JData(vocab=jc.vocab, seed=3).batch(0, 2, 64).items()}
        jm = JModel(jc, JE.from_variant(16, "L-21b"))
        fn = jax.value_and_grad(lambda p: jm.loss(p, b, jm.make_ctx()),
                                has_aux=True)
        _, g = jax.jit(fn)(jp)
        with jax.disable_jit():
            _, g_eager = fn(jp)
        want = [w.double() for w in T.leaves(params_from_jax(
            jax.tree.map(np.asarray, g), jc, device="cpu"))]
        eager = T.leaves(params_from_jax(jax.tree.map(np.asarray, g_eager),
                                         jc, device="cpu"))
        tm = TModel(tc, TE.from_variant(16, "L-21b"), remat=False,
                    device="cpu")
        tp = T.map(lambda p: p.detach().clone().requires_grad_(True),
                   params_from_jax(jax.tree.map(np.asarray, jp), tc,
                                   device="cpu"))
        loss, _ = tm.loss(tp, {k: torch.from_numpy(v.astype(np.int64))
                               for k, v in b.items()}, tm.make_ctx())
        got = torch.autograd.grad(loss, T.leaves(tp))
        for what, leaves in (("port", got), ("JAX eager", eager)):
            errs = np.array([float((gl.double() - w).norm() / w.norm())
                             for gl, w in zip(leaves, want)])
            print(f"{arch:8s} {what:9s} max {errs.max():.3e} (leaf "
                  f"{errs.argmax()}), median {np.median(errs):.2e}, "
                  f"{(errs > GRAD_REL_L2).sum()} of {errs.size} above "
                  f"{GRAD_REL_L2}")


if __name__ == "__main__":
    torch.set_num_threads(4)
    _mismatch_table()
    _grad_errors()
