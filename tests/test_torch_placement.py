"""The production placement on gloo ranks against one process.

Under ``Ctx(placement="production")`` each rank of a (data, model) mesh
holds the blocks of the parameters that ``sharding.params_pspecs`` gives
it, computes column-parallel projections on its columns, row-parallel
ones on its rows with a sum over ``model``, the embedding and the loss
over its block of the vocab, and takes the optimizer step on its ZeRO-1
slices (``training.Zero1``).  Its numbers are the one-process program's
up to the order of f32 sums, which is what the reference's GSPMD
compilation of the same placement gives.

Bars, stated before the first run, SMOKE gemma2-2b, hymba-1.5b and
llama4-scout at (data, model) = (1, 2) and (2, 2), P16 L-21b: every
pre-scale of the forward bit-equal to the one-process forward's, in call
order; the rank's rows of the logits within rtol 1e-4 / atol 2e-3; the
loss within 1e-6 relative; each gradient leaf (the rank's block, summed
over the data axes) within relative L2 1e-3 of the one-process
gradient's block; one ZeRO-1 AdamW step's parameter blocks within
relative L2 1e-6 per leaf, and its moments as many elements as the
reference's ``opt_spec`` gives a device of its stacked ``[L, ...]``
tree.  llama4's expert block on two data ranks takes a data rank's
capacity (the reference's ``shard_map`` semantics),
so there the reference is the same mesh without the placement (the
data- and expert-parallel path, each rank holding the whole tree).

Where the numbers cannot hold those bars, the check moves to the exact
engine, where a fault of the placement shows and f32 summation order is
not amplified by the posit rounding (measured on the CPU):

* the hybrid's whole-model L-21b gradients move by 5e-3 under any change
  of f32 order (JAX's own jit against eager run differs by 5.43e-3,
  ROADMAP queue 3); placed against one process its gradients differ by
  5.4e-3 (dt_bias), its logits by 2.16e-3 at one element of 131072 and
  its loss by 3e-6 relative; on the exact engine by 4e-6, 1.1e-6 and 0.
  So hymba's logits, loss and gradients are held there, and its
  pre-scales at L-21b; its L-21b distances are an open item (ROADMAP
  queue 3);
* AdamW's first step moves each weight by about lr * g / |g|: a
  gradient element near zero that changes between two summation orders
  moves its weight by up to 2 lr, so with L-21b gradients 5e-4 apart
  (gemma2) a step's parameters are 1e-3 apart, and with the exact
  engine's 4e-6 still up to 1.08e-6 (gemma2), 2.28e-6 (llama4) and
  1.56e-5 (hymba's SSM leaves) (relative L2).  So the ZeRO-1 step
  (reduce-scatter, the slices' update, the norm over the slices'
  groups, the all-gather) is held at 1e-6 against the whole-tree AdamW
  step on the rank's own gradients, and its loss against one process's;
  on the exact engine its parameters are held against one process's
  step, at about twice those readings (``STEP_EXACT_REL_L2``).

Serving on the exact engine, prefill of 16 tokens then 7 teacher-forced
decode steps on a dense cache of 24 placed by ``cache_shardings``: the
rank's rows of every step's logits within rtol 1e-4 / atol 2e-3 of one
process's, for gemma2 SMOKE (its 2 KV heads split over ``model``), gemma2
SMOKE with one KV head (the cache's positions split: the sequence-sharded
decode) and hymba SMOKE (the SSM state's heads split).

Pieces on their own: the vocab-parallel cross-entropy and its gradient
against the whole logits' ``logsumexp - logit`` (within 1e-6); the
sequence-sharded decode attention (the softmax's max and sum over
``model``) against one rank holding every position (within 1e-6); the
clip's global norm of a tree of replicated, model-split and data-split
leaves against the whole tree's (within 1e-6 relative).
"""
import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.core import xla_f32 as X
from repro_torch.distributed import sharding as SH
from repro_torch.models.layers import Ctx
from repro_torch.optim import AdamW, global_norm
from repro_torch.training import TrainState, make_train_step
from torch_ranks import (collect, placed_rank, placed_serve_rank,
                         placement_units_rank, record_scales, smoke_model,
                         start)

torch.set_num_threads(1)

ARCHS = ("gemma2-2b", "hymba-1.5b", "llama4-scout-17b-a16e")
SHAPES = ((1, 2), (2, 2))
B, SEQ = 4, 64
LOGITS = dict(rtol=1e-4, atol=2e-3)
LOSS_REL = 1e-6
GRAD_REL_L2 = 1e-3
STEP_REL_L2 = 1e-6
# the ZeRO-1 step on the exact engine against one process's step, per
# leaf: about twice the largest reading on the CPU over both meshes
# (gemma2 1.08e-6, llama4 2.28e-6, hymba 1.56e-5 at its SSM leaves)
STEP_EXACT_REL_L2 = {"gemma2-2b": 5e-6, "hymba-1.5b": 3e-5,
                     "llama4-scout-17b-a16e": 5e-6}


class _Mesh:
    """The rules' view of a (data, model) mesh that was never launched."""

    def __init__(self, shape):
        self.axis_names = ("data", "model")
        self.shape = dict(zip(self.axis_names, shape))


def _rel_l2(got, want) -> float:
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


def _case(arch: str, exact: bool = False):
    model = smoke_model(arch, exact)
    p = T.map(lambda t: t.numpy().copy(), model.init(0))
    rng = np.random.default_rng(7)
    ids = rng.integers(0, model.cfg.vocab, (B, SEQ + 1))
    batch = {"inputs": ids[:, :-1].astype(np.int64),
             "labels": ids[:, 1:].astype(np.int64)}
    return arch, exact, p, batch


def _one_process(arch, exact, p_np, batch_np):
    """The one-process run of what a rank returns."""
    model = smoke_model(arch, exact)
    ctx = Ctx(numerics=model.numerics)
    params = T.map(lambda a: torch.from_numpy(a.copy()).requires_grad_(True),
                   p_np)
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    with torch.no_grad():
        scales = record_scales(lambda: model.loss(params, batch, ctx))
        h, _ = model.forward(params, batch["inputs"], ctx)
        logits = model.head(params, h, ctx)
    loss, _ = model.loss(params, batch, ctx)
    grads = torch.autograd.grad(loss, T.leaves(params))
    opt = AdamW(lr=1e-3)
    state = TrainState(params=params, opt=opt.init(params),
                       step=torch.zeros((), dtype=torch.int32))
    new, metrics = make_train_step(model, opt, ctx)(state, batch)
    return {"scales": scales, "logits": logits, "loss": loss.detach(),
            "grads": grads, "step_loss": metrics["loss"],
            "grad_norm": metrics["grad_norm"],
            "step_params": [t.detach() for t in T.leaves(new.params)]}


def _cases():
    out = {}
    for arch in ARCHS:
        out[arch] = _case(arch)
        out[arch + "/exact"] = _case(arch, exact=True)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = _cases()
    started = {shape: start(placed_rank, shape[0] * shape[1],
                            tmp_path_factory.mktemp("placed"), shape, cases)
               for shape in SHAPES}
    want = {name: _one_process(*case) for name, case in cases.items()}
    got = {shape: collect(s, timeout=600) for shape, s in started.items()}
    return cases, want, got


def _ranks(shape):
    for r in range(shape[0] * shape[1]):
        yield r, {"data": r // shape[1], "model": r % shape[1]}


def _pair(runs, name, shape, r, coord):
    """(what rank ``r`` returned for case ``name``, its reference): one
    process's rows and blocks, or for a MoE model on two data ranks the
    rank's own run without the placement."""
    cases, want, got = runs
    g = got[shape][r][name]
    u = got[shape][r].get(name + "/unplaced")
    w = want[name] if u is None else dict(u, grads=u["grads"],
                                           whole_rows=True)
    mesh = _Mesh(shape)
    p = cases[name][2]
    specs = SH.shardings_in_order(p, SH.params_pspecs(p, mesh))
    rows = B // shape[0]
    own = slice(coord["data"] * rows, (coord["data"] + 1) * rows)
    ref = {"scales": [s for s, _ in w["scales"]], "loss": w["loss"],
           "step_loss": w["step_loss"],
           "logits": w["logits"] if u is not None else w["logits"][own],
           "grads": [SH.local_shard(x, spec, mesh, coord)
                     for x, spec in zip(w["grads"], specs, strict=True)],
           "step_params": [SH.local_shard(x, spec, mesh, coord) for x, spec
                           in zip(w["step_params"], specs, strict=True)],
           "moments": _stacked_moment_elements(p, mesh)}
    return g, ref


def _stacked_moment_elements(p, mesh) -> int:
    """The elements of one AdamW moment a rank holds under the
    reference's ``opt_spec`` of its stacked ``[L, ...]`` tree."""
    n_layers = len(p["layers"])
    total = 0
    for path, a in T.leaves_with_path(p):
        if path[0] == "layers":
            if path[1]:
                continue
            path, shape = ("layers",) + path[2:], (n_layers,) + a.shape
        else:
            shape = a.shape
        ps = SH.param_spec(path, np.broadcast_to(np.float32(0), shape),
                           mesh)
        total += int(np.prod(SH.local_shape(
            shape, SH.opt_spec(ps, shape, mesh), mesh)))
    return total


def _held(arch):
    """The case whose logits, loss and gradients hold the bars: the exact
    engine's for hymba (see above), else the L-21b one."""
    return arch + "/exact" if arch == "hymba-1.5b" else arch


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_prescales_and_logits(runs, arch, shape):
    for r, coord in _ranks(shape):
        g, ref = _pair(runs, arch, shape, r, coord)
        assert [s for s, _ in g["scales"]] == ref["scales"]
        g, ref = _pair(runs, _held(arch), shape, r, coord)
        assert g["logits"].shape == ref["logits"].shape
        torch.testing.assert_close(g["logits"], ref["logits"], **LOGITS)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_loss_and_grads(runs, arch, shape):
    for r, coord in _ranks(shape):
        g, ref = _pair(runs, _held(arch), shape, r, coord)
        assert abs(float(g["loss"]) - float(ref["loss"])) <= \
            LOSS_REL * abs(float(ref["loss"]))
        for gl, wl in zip(g["grads"], ref["grads"], strict=True):
            assert gl.shape == wl.shape
            assert _rel_l2(gl, wl) <= GRAD_REL_L2


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_zero1_step(runs, arch, shape):
    for r, coord in _ranks(shape):
        g, ref = _pair(runs, _held(arch), shape, r, coord)
        assert abs(float(g["step_loss"]) - float(ref["step_loss"])) <= \
            LOSS_REL * abs(float(ref["step_loss"]))
        g, ref = _pair(runs, arch, shape, r, coord)
        for gp, wp in zip(g["step_params"], g["replicated_step"],
                          strict=True):
            assert gp.shape == wp.shape
            assert _rel_l2(gp, wp) <= STEP_REL_L2
        assert sum(int(np.prod(m)) for m in g["moments"]) == ref["moments"]
        g, ref = _pair(runs, arch + "/exact", shape, r, coord)
        for gp, wp in zip(g["step_params"], ref["step_params"], strict=True):
            assert _rel_l2(gp, wp) <= STEP_EXACT_REL_L2[arch]


def test_placement_pieces(tmp_path):
    """The vocab-parallel loss, the sequence-sharded decode's combine and
    the group-aware global norm, on (1, 2) and (2, 2)."""
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((6, 32)) * 4).astype(np.float32)
    labels = rng.integers(0, 32, 6)
    scores = rng.standard_normal((2, 2, 1, 3, 16)).astype(np.float32) * 3
    scores[1, ..., 11:] = -1e30          # masked positions past row 1's
    values = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    leaves = [rng.standard_normal(s).astype(np.float32)
              for s in ((8,), (8, 6), (4, 8), (2, 4, 8))]
    specs = [SH.P(), SH.P(None, "model"), SH.P("data", "model"),
             SH.P("model", None, "data")]
    started = [start(placement_units_rank, a * b, tmp_path / f"{a}x{b}",
                     (a, b), (logits, labels), (scores, values),
                     (leaves, specs)) for a, b in SHAPES]

    lt = torch.from_numpy(logits).requires_grad_(True)
    want_xent = X.logsumexp(lt, -1) - lt[torch.arange(6), labels]
    (want_grad,) = torch.autograd.grad(want_xent.sum(), lt)
    st, vt = torch.from_numpy(scores), torch.from_numpy(values)
    probs = torch.softmax(st, -1)
    want_att = torch.einsum("bktgs,bskd->btkgd", probs, vt).reshape(
        2, 1, 2 * 3 * 8)
    want_norm = global_norm([torch.from_numpy(a) for a in leaves])
    for (a, b), s in zip(SHAPES, started):
        mesh = _Mesh((a, b))
        outs = collect(s)
        for r, coord in _ranks((a, b)):
            o = outs[r]
            torch.testing.assert_close(o["xent"], want_xent.detach(),
                                       rtol=0, atol=1e-6)
            torch.testing.assert_close(
                o["xent_grad"], SH.local_shard(want_grad, SH.P(None, "model"),
                                               mesh, coord),
                rtol=0, atol=1e-6)
            torch.testing.assert_close(o["attended"], want_att, rtol=0,
                                       atol=1e-6)
            assert abs(float(o["norm"]) - float(want_norm)) <= \
                1e-6 * float(want_norm)


SERVE_CASES = {"gemma2": ("gemma2-2b", {}), "gemma2 MQA": (
    "gemma2-2b", {"n_kv_heads": 1}), "hymba": ("hymba-1.5b", {})}


def test_placed_serving_matches_one_process(tmp_path):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.engine import EulerConfig
    from repro_torch.models.transformer import Model
    rng = np.random.default_rng(5)
    cases, want = {}, {}
    for name, (arch, kw) in SERVE_CASES.items():
        cfg = dataclasses.replace(get_config(arch).SMOKE, **kw)
        model = Model(cfg, EulerConfig(mode="exact"), remat=False,
                      device="cpu")
        params = model.init(0)
        ids = rng.integers(0, cfg.vocab, (B, 24)).astype(np.int64)
        cases[name] = (arch, kw, T.map(lambda t: t.numpy().copy(), params),
                       ids, 16)
        cache = model.init_cache(B, 24)
        ctx = Ctx(numerics=model.numerics)
        idt = torch.from_numpy(ids)
        with torch.no_grad():
            logits, cache = model.prefill(params, idt[:, :16], ctx, cache)
            steps = [logits]
            for i in range(16, 23):
                logits, cache = model.decode_step(params, idt[:, i], i,
                                                  cache, ctx)
                steps.append(logits)
        want[name] = torch.stack(steps, 1)
    started = {shape: start(placed_serve_rank, shape[0] * shape[1],
                            tmp_path / f"{shape[0]}x{shape[1]}", shape, cases)
               for shape in SHAPES}
    for shape, s in started.items():
        rows = B // shape[0]
        for r, o in enumerate(collect(s)):
            own = slice((r // shape[1]) * rows, (r // shape[1] + 1) * rows)
            for name in SERVE_CASES:
                torch.testing.assert_close(o[name]["logits"],
                                           want[name][own], **LOGITS)
            # one KV head on two model ranks: each holds 12 of 24 positions
            assert o["gemma2 MQA"]["cache_shapes"]["k"][2:4] == (12, 1)
            assert o["gemma2"]["cache_shapes"]["k"][3] == 1
