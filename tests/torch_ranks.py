"""Rank processes for the port's multi-device tests on the CPU.

:func:`spawn` runs a function on N gloo ranks (``torch.multiprocessing``,
a ``FileStore`` under the test's tmp dir, so test files run in parallel
under pytest-xdist) and returns what each rank returned.  The rank bodies
live here and import torch only, so a rank starts in about a second;
:func:`run_jax` starts the JAX side of a comparison in a subprocess on 8
host devices (the test process keeps its one device, as
``tests/conftest.py`` requires).
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def spawn(fn, world: int, tmp, *args) -> list:
    """``fn(rank, world, *args)`` on ``world`` gloo ranks; each rank's
    return value, in rank order."""
    return collect(start(fn, world, tmp, *args))


def start(fn, world: int, tmp, *args):
    """:func:`spawn` without waiting: pass the result to :func:`collect`."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    ctx = mp.start_processes(
        _entry, args=(world, os.path.join(tmp, "store"), fn, args, tmp),
        nprocs=world, join=False, start_method="spawn")
    return ctx, world, tmp


def collect(started, timeout: float = 300) -> list:
    ctx, world, tmp = started
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            raise TimeoutError(f"{world} ranks still running after "
                               f"{timeout} s")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _entry(rank, world, store, fn, args, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_jax(code: str) -> subprocess.Popen:
    """JAX ``code`` in a subprocess with 8 host devices (wait on it with
    :func:`wait_jax`)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = SRC + os.pathsep + os.path.dirname(
        os.path.abspath(__file__))
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def wait_jax(proc: subprocess.Popen, timeout: float = 300) -> str:
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out + "\n" + err
    return out


def torch_tree(tree):
    """numpy leaves -> CPU float32 tensors (dicts and lists kept)."""
    if isinstance(tree, dict):
        return {k: torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [torch_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def l21b(width: int = 16, backend: str = "lax_ref"):
    from repro_torch.core.engine import from_variant
    from repro_torch.numerics import NumericsContext
    return NumericsContext.from_ecfg(from_variant(width, "L-21b"),
                                     backend=backend)


# --------------------------------------------------------------------------
# collectives and group statistics (test_torch_collectives_mp.py)
# --------------------------------------------------------------------------

def subnormal_stats_rank(rank, world, x):
    """``x`` [world, m] with subnormal values: the group's pow2 scale, the
    split encode's plain version (B-P16) and logfxp's frac exponent of
    this rank's row (test_torch_subnormal_flush.py)."""
    from repro_torch.core import engine as E
    from repro_torch.core import logmult as LM
    from repro_torch.core.posit import BPOSIT16
    from repro_torch.kernels import posit_codec as PC
    g = dist.group.WORLD
    xl = torch.from_numpy(x[rank:rank + 1])
    out = {"scale": E._pow2_scale(xl, g),
           "frac_exp": LM.fxp_frac_exp(xl, 8, g)}
    out["words"], out["words_scale"] = PC.encode_prescaled_plain(
        xl, BPOSIT16, True, g)
    return out


def collectives_rank(rank, world, x, y):
    """``x`` [world, n]: compressed psum/pmean of this rank's row.  ``y``
    [world, m] with rows at rank-dependent scales: the group statistics
    of this rank's row.  Then the autograd collectives and the tree
    all-reduce / broadcast."""
    from repro_torch.core import engine as E
    from repro_torch.core import logmult as LM
    from repro_torch.core.posit import PositConfig
    from repro_torch.distributed import collectives as C
    from repro_torch.kernels import posit_codec as PC
    g = dist.group.WORLD
    out = {}
    xl = torch.from_numpy(x[rank:rank + 1])
    out["psum"] = C.compressed_psum(xl, g)
    out["pmean"] = C.compressed_pmean(xl, g)
    yl = torch.from_numpy(y[rank:rank + 1])
    out["scale"] = E._pow2_scale(yl, g)
    out["local_scale"] = E._pow2_scale(yl)
    out["frac_exp"] = LM.fxp_frac_exp(yl, 8, g)
    pc = PositConfig(16, 1, 3)
    out["words"], out["words_scale"] = PC.encode_prescaled_plain(
        yl, pc, True, g)
    # reduce_sum: each rank's gradient is its own share
    a = torch.full((3,), float(rank + 1), requires_grad=True)
    s = C.reduce_sum(a, g)
    (s * torch.arange(3.0)).sum().backward()
    out["reduce_sum"], out["reduce_sum_grad"] = s.detach(), a.grad
    # copy_sum_grad: the gradient summed over the group
    b = torch.ones(2, requires_grad=True)
    (C.copy_sum_grad(b, g) * (rank + 1)).sum().backward()
    out["copy_grad"] = b.grad
    # gather_dim: blocks along dim 1, the gradient reduce-scattered
    w = (torch.arange(6.0).reshape(2, 3) + 10 * rank).requires_grad_(True)
    full = C.gather_dim(w, 1, g)
    coef = torch.arange(float(full.numel())).reshape(full.shape)
    (full * coef).sum().backward()
    out["gathered"], out["gather_grad"] = full.detach(), w.grad
    tree = {"b": [torch.full((5,), float(rank)), torch.arange(3) + rank],
            "a": torch.full((2, 2), 2.0 * rank)}
    out["tree_sum"] = C.all_reduce_tree(tree, g, bucket_bytes=16)
    out["bcast"] = C.broadcast_tree(
        {"w": torch.full((4,), float(rank)), "n": torch.tensor([rank])})
    # the multi-pod layout: pod and data joined into one group
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    jg = mesh.group(("pod", "data"))
    out["joint"] = (dist.get_world_size(jg), mesh.index(("pod", "data")),
                    int(C.all_reduce(torch.tensor([rank]), jg)),
                    mesh.coord)
    return out


# --------------------------------------------------------------------------
# expert-parallel MoE (test_torch_moe_ep.py, test_torch_costmodel.py)
# --------------------------------------------------------------------------

def moe_rank(rank, world, p_np, x, runs):
    """llama4-smoke's ``moe_apply`` on a (1, 2) or (2, 2) mesh: this
    rank's output rows, the aux loss and the collective bytes per run."""
    from repro_torch.configs import llama4_scout_17b_a16e as TL
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import Ctx, moe_apply
    mesh = make_mesh((world // 2, 2), ("data", "model"), device="cpu")
    p = torch_tree(p_np)
    xg = torch.from_numpy(x)
    xl = SH.local_shard(xg, SH.batch_spec(mesh, 2, xg.shape[0]), mesh)
    out = {}
    for name, kw in runs.items():
        C.reset_bytes()
        ctx = Ctx(numerics=l21b(), mesh=mesh, **kw)
        y, aux = moe_apply(p, xl, ctx, TL.SMOKE)
        out[name] = {"y": y, "aux": aux, "bytes": dict(C.BYTES)}
    return out


def moe_cost_rank(rank, world, p_np, x):
    """Cost counts of llama4-smoke's ``moe_apply`` on the exact backend,
    on this rank of a (1, 2) mesh."""
    from repro_torch.analysis import costmodel
    from repro_torch.configs import llama4_scout_17b_a16e as TL
    from repro_torch.core.engine import EulerConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import Ctx, moe_apply
    from repro_torch.numerics import NumericsContext
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    ctx = Ctx(numerics=NumericsContext.from_ecfg(EulerConfig(mode="exact"),
                                                 backend="exact"), mesh=mesh)
    p, xt = torch_tree(p_np), torch.from_numpy(x)
    return costmodel.analyze(lambda: moe_apply(p, xt, ctx, TL.SMOKE))


# --------------------------------------------------------------------------
# the data-parallel step (test_torch_dp_train.py)
# --------------------------------------------------------------------------

def record_scales(fn):
    """``fn()`` with every pow2 pre-scale recorded: [(scale, the
    operand's local scale)] in call order."""
    from repro_torch.core import engine as E
    rec, orig = [], E._pow2_scale

    def spy(x, group=None):
        s = orig(x, group)
        rec.append((float(s), float(orig(x)) if group is not None
                    else float(s)))
        return s

    E._pow2_scale = spy
    try:
        fn()
    finally:
        E._pow2_scale = orig
    return rec


# the reference's training CFG (tests/test_training.py:18)
CFG = dict(name="tiny", family="dense", n_layers=2, d_model=128, n_heads=4,
           n_kv_heads=2, d_ff=256, vocab=512, loss_chunk=32, q_chunk=64,
           kv_chunk=64)


def torch_config(arch: str):
    from repro_torch.configs import mamba2_1p3b
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**CFG) if arch == "cfg" else mamba2_1p3b.SMOKE


def model_of(arch: str, remat: bool = False):
    from repro_torch.core.engine import from_variant
    from repro_torch.models.transformer import Model
    return Model(torch_config(arch), from_variant(16, "L-21b"), remat=remat,
                 device="cpu")


def dp_rank(rank, world, cases):
    """Per case (arch, params as numpy, global batch): this rank's
    forward pre-scales, the loss and the summed gradients of the data-
    parallel loss, and one train step's loss and parameters."""
    from repro_torch import tree as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import Ctx
    from repro_torch.optim import AdamW
    from repro_torch.training import (TrainState, broadcast_state,
                                      make_train_step, rank_rows,
                                      sync_grads)
    mesh = make_mesh((world,), ("data",), device="cpu")
    out = {}
    for name, (arch, p_np, batch_np) in cases.items():
        model = model_of(arch)
        ctx = Ctx(numerics=model.numerics, mesh=mesh)
        params = T.map(lambda t: t.requires_grad_(True), torch_tree(p_np))
        batch = rank_rows({k: torch.from_numpy(v) for k, v in
                           batch_np.items()}, ctx)
        with torch.no_grad():
            scales = record_scales(lambda: model.loss(params, batch, ctx))
        loss, _ = model.loss(params, batch, ctx)
        grads = torch.autograd.grad(loss, T.leaves(params))
        grads = sync_grads(T.unflatten(params, list(grads)), ctx)
        opt = AdamW(lr=1e-3)
        p0 = T.map(lambda t: t.requires_grad_(True), torch_tree(p_np))
        if rank:   # rank 0's parameters reach every rank
            p0 = T.map(lambda t: torch.zeros_like(t).requires_grad_(True),
                       p0)
        state = broadcast_state(TrainState(
            params=p0, opt=opt.init(p0),
            step=torch.zeros((), dtype=torch.int32)))
        new, metrics = make_train_step(model, opt, ctx)(state, batch)
        out[name] = {"scales": scales, "loss": loss.detach(),
                     "grads": T.map(lambda g: g.detach(), grads),
                     "step_loss": metrics["loss"],
                     "step_params": T.map(lambda t: t.detach(), new.params)}
    return out


def launcher_rank(rank, world, argv):
    """``launch.train`` on a 1-D data mesh of this world (the production
    mesh's code path at a size a CPU holds)."""
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    args = train.parser().parse_args(argv)
    mesh = make_mesh((world,), ("data",), device="cpu")
    rep = train._train(args, mesh)
    return {"losses": rep["losses"], "grad_norms": rep["grad_norms"]}


# --------------------------------------------------------------------------
# the production placement (test_torch_placement.py)
# --------------------------------------------------------------------------

def smoke_model(arch: str, exact: bool = False):
    """The SMOKE model of ``arch`` on the CPU under P16 L-21b (or the
    exact engine), no remat."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import EulerConfig, from_variant
    from repro_torch.models.transformer import Model
    ecfg = EulerConfig(mode="exact") if exact else from_variant(16, "L-21b")
    return Model(get_config(arch).SMOKE, ecfg, remat=False, device="cpu")


def _forward_loss_step(model, params, batch, ctx, step_state):
    """The forward's pre-scales and logits, the loss and its gradients
    (leaf order) and one AdamW step from ``step_state``."""
    from repro_torch import tree as T
    from repro_torch.optim import AdamW
    from repro_torch.training import make_train_step
    with torch.no_grad():
        scales = record_scales(lambda: model.loss(params, batch, ctx))
        h, _ = model.forward(params, batch["inputs"], ctx)
        logits = model.head(params, h, ctx)
    loss, _ = model.loss(params, batch, ctx)
    grads = list(torch.autograd.grad(loss, T.leaves(params)))
    new, metrics = make_train_step(model, AdamW(lr=1e-3), ctx)(
        step_state(params), batch)
    return {"scales": scales, "logits": logits, "loss": loss.detach(),
            "grads": grads, "step_loss": metrics["loss"],
            "step_params": [t.detach() for t in T.leaves(new.params)],
            "moments": [tuple(t.shape) for t in T.leaves(new.opt["m"])]}


def placed_rank(rank, world, shape, cases):
    """Per case (arch, exact engine, whole parameters as numpy, global
    batch): on a (data, model) = ``shape`` mesh under the production
    placement, the forward's pre-scales, this rank's rows of the logits,
    the loss, the gradients (the rank's blocks, summed over the data
    axes) and one ZeRO-1 AdamW step's loss and parameter blocks.  For a
    MoE model on more than one data rank also the same on the mesh
    without the placement (each rank holding the whole tree, gradients
    summed by ``sync_grads``; the expert block's capacity is a data
    rank's, so one process is not the reference there)."""
    from repro_torch import tree as T
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import Ctx
    from repro_torch.optim import AdamW
    from repro_torch.training import (TrainState, init_placed_state,
                                      rank_rows, sync_grads)
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    opt = AdamW(lr=1e-3)
    out = {}
    for name, (arch, exact, p_np, batch_np) in cases.items():
        model = smoke_model(arch, exact)
        ctx = Ctx(numerics=model.numerics, mesh=mesh, placement="production")
        whole = torch_tree(p_np)
        params = SH.place(whole, SH.params_pspecs(whole, mesh), mesh)
        params = T.map(lambda t: t.requires_grad_(True), params)
        batch = rank_rows({k: torch.from_numpy(v)
                           for k, v in batch_np.items()}, ctx)
        out[name] = _forward_loss_step(
            model, params, batch, ctx,
            lambda p: init_placed_state(model, opt, mesh, p))
        grads = [C.all_reduce(g.clone(), ctx.data_group)
                 for g in out[name]["grads"]]
        out[name]["grads"] = grads
        # the whole-tree AdamW step on the same gradients, cut to the
        # rank's blocks: what ZeRO-1 must give up to f32 order
        specs = SH.shardings_in_order(whole, SH.params_pspecs(whole, mesh))
        full = []
        for g, spec in zip(grads, specs):
            for dim, ax in enumerate(spec):
                if ax == "model":
                    g = C.all_gather_dim(g, dim, ctx.model_group)
            full.append(g)
        with torch.no_grad():
            stepped, _, _ = opt.update(T.unflatten(whole, full),
                                       opt.init(whole), whole)
        out[name]["replicated_step"] = T.leaves(SH.place(
            stepped, SH.params_pspecs(whole, mesh), mesh))
        if model.cfg.family == "moe" and shape[0] > 1:
            ctx_u = Ctx(numerics=model.numerics, mesh=mesh)
            whole = T.map(lambda t: t.requires_grad_(True), whole)
            u = _forward_loss_step(model, whole, batch, ctx_u, lambda p: (
                TrainState(params=p, opt=opt.init(p),
                           step=torch.zeros((), dtype=torch.int32))))
            u["grads"] = T.leaves(sync_grads(
                T.unflatten(whole, u["grads"]), ctx_u))
            out[name + "/unplaced"] = u
    return out


def placement_units_rank(rank, world, shape, xent, decode, norm):
    """The pieces of the placement on a (data, model) = ``shape`` mesh:
    the vocab-parallel cross-entropy of this rank's vocab block
    (``xent``: logits [n, V], labels [n]) and its gradient; the
    sequence-sharded decode attention of this rank's block of positions
    (``decode``: scores [B, KV, 1, g, S], values [B, S, KV, hd]); the
    global norm of a mixed tree (``norm``: whole leaves, each cut by its
    spec) with the leaves' groups."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import Ctx, seq_sharded_attend
    from repro_torch.models.transformer import vocab_parallel_xent
    from repro_torch.optim import global_norm
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    ctx = Ctx(mesh=mesh, placement="production")
    mg = ctx.model_group
    logits, labels = (torch.from_numpy(a) for a in xent)
    part = SH.local_shard(logits, SH.P(None, "model"), mesh)
    part.requires_grad_(True)
    loss = vocab_parallel_xent(part, labels, mg)
    (g,) = torch.autograd.grad(loss.sum(), part)
    scores, values = (torch.from_numpy(a) for a in decode)
    s_blk = SH.local_shard(scores, SH.P(None, None, None, None, "model"),
                           mesh)
    v_blk = SH.local_shard(values, SH.P(None, "model"), mesh)
    attended = seq_sharded_attend(s_blk, v_blk, ctx)
    leaves, specs = norm
    blocks = [SH.local_shard(torch.from_numpy(a), spec, mesh)
              for a, spec in zip(leaves, specs)]
    groups = [mesh.group(tuple(a for s in spec if s is not None
                               for a in (s if isinstance(s, tuple) else (s,))))
              for spec in specs]
    return {"xent": loss.detach(), "xent_grad": g, "attended": attended,
            "norm": global_norm(blocks, groups),
            "bytes": C.group_size(mg)}


def placed_serve_rank(rank, world, shape, cases):
    """Per case (arch, config fields to replace, whole parameters, ids
    [B, T0 + steps]): under the production placement on a (data, model)
    = ``shape`` mesh, on the exact engine, this rank's rows of the
    prefill's logits over the first T0 tokens and of each teacher-forced
    decode step's, on a dense cache of ``T0 + steps`` placed by
    ``cache_shardings`` (sequence-sharded where the KV heads do not
    divide ``model``)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.engine import EulerConfig
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import Ctx
    from repro_torch.models.transformer import Model
    from repro_torch.training import rank_rows
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    out = {}
    for name, (arch, kw, p_np, ids_np, t0) in cases.items():
        cfg = dataclasses.replace(get_config(arch).SMOKE, **kw)
        model = Model(cfg, EulerConfig(mode="exact"), remat=False,
                      device="cpu")
        S = ids_np.shape[1]
        ctx = Ctx(numerics=model.numerics, mesh=mesh,
                  placement="production")
        whole = torch_tree(p_np)
        params = SH.place(whole, SH.params_pspecs(whole, mesh), mesh)
        ids = rank_rows({"ids": torch.from_numpy(ids_np)}, ctx)["ids"]
        cache = model.init_cache(ids_np.shape[0], S, mesh=mesh)
        with torch.no_grad():
            logits, cache = model.prefill(params, ids[:, :t0], ctx, cache)
            steps = [logits]
            for i in range(t0, S - 1):
                logits, cache = model.decode_step(params, ids[:, i], i,
                                                  cache, ctx)
                steps.append(logits)
        out[name] = {"logits": torch.stack(steps, 1),
                     "cache_shapes": {k: tuple(v.shape)
                                      for k, v in cache.items()}}
    return out
