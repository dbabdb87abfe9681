"""The port's cost model (a dispatch mode over aten ops) against the JAX
reference's trip-count-aware jaxpr walk, on the five functions of
``tests/test_costmodel.py`` written in torch (a Python loop stands in for
each ``scan``), the checkpointed toy under the two remat policies and
gemma2 SMOKE's forward on the ``exact`` backend.

Bars: integer equality.  ``dot_flops`` and ``dot_traffic`` equal the
reference's everywhere.  ``dots`` counts executions, the reference counts
its jaxpr's dot equations once each, so under a loop the port's is the
reference's times the trip count (equal without one).  ``ew_flops`` is
held where the aten map is one-to-one: the toys' forward passes (``tanh``,
``pow``, ``sum``); not the backward passes (torch's fused
``tanh_backward`` and ``pow_backward`` against JAX's ``mul``/``sub``
chains) nor the models (the XLA-rounding transcriptions of
``core/xla_f32.py`` run many elementwise ops for one primitive).

The reference's ``shard_map`` multiplier: llama4-smoke's ``moe_apply``
counted on one rank of a (data, model) = (1, 2) mesh (two gloo ranks)
reports the reference's single-device ``dot_flops`` and ``dot_traffic``:
the expert block runs on half the experts and counts twice, the router
outside it once.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro.analysis import costmodel as JCM
from repro.configs import gemma2_2b as JG
from repro.core.engine import EulerConfig as JEC
from repro.models.transformer import Model as JModel
from repro_torch.analysis import costmodel as TCM
from repro_torch.configs import gemma2_2b as TG
from repro_torch.core.engine import EulerConfig as TEC, no_batch_dot
from repro_torch.models.transformer import Model as TModel, save_no_batch_dots

torch.set_num_threads(1)

KEYS = ("dot_flops", "dot_traffic")


def _meta(*shapes):
    return [torch.empty(s, device="meta") for s in shapes]


def _sds(*shapes):
    return [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]


def _jscan(ws, x):
    def body(h, w):
        return jnp.tanh(h @ w), None
    return jax.lax.scan(body, x, ws)[0]


def _tloop(ws, x):
    h = x
    for w in ws:
        h = torch.tanh(h @ w)
    return h


def _jnested(ws, x):
    def outer(h, w):
        def inner(h2, _):
            return h2 @ w, None
        return jax.lax.scan(inner, h, jnp.arange(3))[0], None
    return jax.lax.scan(outer, x, ws)[0]


def _tnested(ws, x):
    h = x
    for w in ws:
        for _ in range(3):
            h = h @ w
    return h


# name: (JAX function, port function, shapes, trip count)
TOYS = {
    "plain_dot": (lambda a, b: a @ b, lambda a, b: a @ b,
                  [(8, 32), (32, 16)], 1),
    "scan": (_jscan, _tloop, [(7, 16, 16), (4, 16)], 7),
    "nested_scan": (_jnested, _tnested, [(5, 16, 16), (4, 16)], 15),
    "batched_dot": (lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
                    lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                    [(6, 8, 12), (6, 12, 10)], 1),
}


@pytest.mark.parametrize("name", sorted(TOYS))
def test_toy_counts_equal_reference(name):
    jf, tf, shapes, trips = TOYS[name]
    want = JCM.analyze(jf, *_sds(*shapes))
    got = TCM.analyze(tf, *_meta(*shapes))
    for k in KEYS + ("ew_flops",):
        assert got[k] == want[k], (k, got[k], want[k])
    assert got["dots"] == want["dots"] * trips


def test_real_and_meta_tensors_count_alike(rng):
    shapes = TOYS["scan"][2]
    real = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in shapes]
    assert (TCM.analyze(_tloop, *real)
            == TCM.analyze(_tloop, *_meta(*shapes)))


@pytest.mark.parametrize("name", sorted(TOYS))
def test_traced_graph_counts_equal_dispatch_counts(name):
    """``analyze_graph`` over the ``make_fx`` trace of each toy (its loops
    unrolled) counts what ``analyze`` counts at dispatch."""
    from torch.fx.experimental.proxy_tensor import make_fx
    _, tf, shapes, _ = TOYS[name]
    args = [torch.zeros(s) for s in shapes]
    gm = make_fx(tf)(*args)
    assert TCM.analyze_graph(gm.graph) == TCM.analyze(tf, *args)


def _jremat(policy):
    def f(w, x):
        h = jax.checkpoint(lambda a: jnp.tanh(a @ w), policy=policy)(x)
        return (h ** 2).sum()
    return f


def _tremat(context_fn):
    def f(w, x):
        def block(a):
            with no_batch_dot():    # a dot with no batch dims, as in JAX
                y = a @ w
            return torch.tanh(y)
        kw = {"context_fn": context_fn} if context_fn else {}
        h = checkpoint(block, x, use_reentrant=False, **kw)
        return (h ** 2).sum()
    return f


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_counts_recompute(policy):
    """Backward under remat: the forward dot, its recompute (not under
    "dots", which saves it) and two gradient dots: 4x and 3x the forward's
    dot FLOPs, as JAX's ``analyze(jax.grad(...))`` under the policy."""
    jpol = {"nothing": jax.checkpoint_policies.nothing_saveable,
            "dots": jax.checkpoint_policies.dots_with_no_batch_dims_saveable
            }[policy]
    ctx_fn = (functools.partial(create_selective_checkpoint_contexts,
                                save_no_batch_dots)
              if policy == "dots" else None)
    w_s, x_s = (32, 32), (8, 32)
    jf = _jremat(jpol)
    jfwd = JCM.analyze(jf, *_sds(w_s, x_s))
    jbwd = JCM.analyze(jax.grad(jf, argnums=(0, 1)), *_sds(w_s, x_s))
    tf = _tremat(ctx_fn)
    w, x = (torch.randn(s, requires_grad=True) for s in (w_s, x_s))
    tfwd = TCM.analyze(tf, w, x)

    def grad(w, x):
        torch.autograd.grad(tf(w, x), (w, x))

    tbwd = TCM.analyze(grad, w, x)
    times = {"nothing": 4, "dots": 3}[policy]
    assert jbwd["dot_flops"] == times * jfwd["dot_flops"]
    for k in KEYS:
        assert tfwd[k] == jfwd[k] and tbwd[k] == jbwd[k], (k, tbwd, jbwd)
    assert tfwd["ew_flops"] == jfwd["ew_flops"]


def test_gemma2_smoke_forward_dot_counts_equal_reference():
    """gemma2 SMOKE's ``Model.forward`` ([2, 64] token ids) on ``exact``:
    every projection and attention contraction, the local layers' masked kv
    chunks included, as the reference's scans compute them."""
    jm = JModel(JG.SMOKE, JEC(mode="exact"))
    ps = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    want = JCM.analyze(lambda p, x: jm.forward(p, x, jm.make_ctx())[0], ps,
                       jax.ShapeDtypeStruct((2, 64), jnp.int32))
    tm = TModel(TG.SMOKE, TEC(mode="exact"), device="cpu")
    params = tm.init(0)
    with torch.no_grad():
        got = TCM.analyze(lambda p, x: tm.forward(p, x, tm.make_ctx()),
                          params, torch.zeros((2, 64), dtype=torch.int64))
    for k in KEYS:
        assert got[k] == want[k], (k, got[k], want[k])
    assert got["dots"] > want["dots"]    # executions, not equations


def test_expert_parallel_block_counts_times_the_mesh_size(tmp_path):
    from repro.configs import llama4_scout_17b_a16e as JL
    from repro.models import layers as JLy
    from repro.models.layers import Ctx as JCtx
    from repro.numerics import NumericsContext as JN
    from torch_ranks import moe_cost_rank, spawn
    cfg = JL.SMOKE
    jp = JLy.moe_init(jax.random.PRNGKey(1), cfg)
    p = jax.tree.map(np.array, jp)
    x = np.random.default_rng(0).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    jctx = JCtx(numerics=JN.from_ecfg(JEC(mode="exact"), backend="exact"))
    want = JCM.analyze(lambda pp, xx: JLy.moe_apply(pp, xx, jctx, cfg),
                       jp, jnp.asarray(x))
    got = spawn(moe_cost_rank, 2, tmp_path, p, x)
    for counts in got:
        for k in KEYS:
            assert counts[k] == want[k], (k, counts[k], want[k])
