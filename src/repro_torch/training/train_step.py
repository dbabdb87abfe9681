"""Train-step factory: micro-batched gradient accumulation, remat, the
EULER QAT forward (straight-through gradients), optional int8 gradient
compression with error feedback.

Counterpart of ``repro.training.train_step``.  ``train_step(state, batch)``
returns a new :class:`TrainState`; the parameters it holds are leaf
tensors that require grad, replaced (not updated in place) each step.
Gradients come from ``torch.autograd.grad`` through ``Model.loss``, as the
reference's come from ``jax.value_and_grad``; the numerics backend must be
differentiable (``lax_ref`` or ``exact``: the ``cuda`` backend refuses).

Checkpoints (``distributed.checkpoint``): :func:`save_state` writes the
state's tree; :func:`restore_state` reads it back, or a ``TrainState`` the
JAX trainer wrote (its layers and moments stacked ``[L, ...]``, converted
with ``params_from_jax``).

Data parallel: under ``ctx.mesh`` the step is the reference's launcher's
(``--mesh``: the train state replicated, GSPMD partitioning the batch).
Every rank holds the whole state (:func:`broadcast_state` copies rank 0's)
and its rows of the global batch (:func:`rank_rows`, over the data axes);
``Model.loss`` returns the global loss with each rank's share of its
gradient, and the step sums the gradients over the data group, in
buckets (``collectives.all_reduce_tree``), before ``ef_compress`` and the
optimizer.  With experts over ``model``, a rank's expert-stack gradients
hold its experts' rows only, and are summed over the model group too.
Up to the order of f32 sums, the step is the one-process step on the
concatenated batch; with ``grad_accum`` each rank splits its own rows, so
micro-batch i is every rank's i-th block.

Under the production placement (``Ctx(placement="production")``) a rank
holds its blocks of the parameters and its ZeRO-1 slices of the moments
(:func:`init_placed_state`) and :class:`Zero1` takes the optimizer step.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.distributed import checkpoint as CK
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as SH
from repro_torch.models.layers import Ctx
from repro_torch.models.transformer import params_from_jax
from repro_torch.optim.adamw import AdamW


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: Any
    step: torch.Tensor
    ef: Any = None  # error-feedback residual (grad compression), optional

    def tree(self) -> dict:
        """The state as the tree a checkpoint stores."""
        return {"params": self.params, "opt": self.opt, "step": self.step,
                "ef": self.ef}

    def to(self, device) -> "TrainState":
        """A copy on ``device``, its parameters trainable there."""
        t = T.map(lambda x: x.detach().to(device), self.tree())
        t["params"] = _trainable(t["params"])
        return TrainState(**t)


def _trainable(params):
    return T.map(lambda p: p.detach().requires_grad_(True), params)


def init_state(model, optimizer: AdamW, seed: int = 0, *,
               compress: bool = False) -> TrainState:
    """Parameters from ``model.init(seed)`` (an explicit ``torch.Generator``
    on the model's device), zero optimizer state and step 0."""
    params = _trainable(model.init(seed))
    opt = optimizer.init(params)
    ef = collectives.ef_init(params) if compress else None
    step = torch.zeros((), dtype=torch.int32, device=model.device)
    return TrainState(params=params, opt=opt, step=step, ef=ef)


def broadcast_state(state: TrainState) -> TrainState:
    """Every rank's state overwritten with rank 0's, in place (one
    process: as it is)."""
    collectives.broadcast_tree(state.tree())
    return state


def rank_rows(batch, ctx: Ctx):
    """This rank's rows of a global batch under ``ctx.mesh``: the batch
    dim cut into one block per data rank (``sharding.batch_spec``), the
    first data axis major.  The global batch must divide by the data
    ranks."""
    mesh = ctx.mesh
    if mesh is None:
        return batch
    dp = SH.dp_size(mesh)
    if dp == 1:
        return batch

    def rows(x):
        if x.shape[0] % dp:
            raise ValueError(f"global batch {x.shape[0]} does not split "
                             f"over {dp} data ranks")
        return SH.local_shard(x, SH.batch_spec(mesh, x.ndim - 1,
                                               x.shape[0]), mesh)
    return T.map(rows, batch)


def _is_expert_stack(path, leaf) -> bool:
    return ("moe" in path and path[-1] == "w"
            and path[-2] in ("wi", "wg", "wo") and leaf.ndim == 3)


def sync_grads(grads, ctx: Ctx, bucket_bytes: int = 64 << 20):
    """Each rank's gradient summed over the data group; expert stacks
    also over the model group (a model rank's hold its experts' rows).
    Not under the production placement, where a leaf split over
    ``model`` holds the rank's block and :class:`Zero1` sums over the data
    axes alone."""
    if ctx.placed:
        raise ValueError("the production placement sums gradients in "
                         "Zero1.reduce")
    grads = collectives.all_reduce_tree(grads, ctx.data_group, bucket_bytes)
    mg = ctx.model_group
    if mg is None:
        return grads
    return T.map_with_path(
        lambda path, g: (collectives.all_reduce(g.clone(), mg)
                         if _is_expert_stack(path, g) else g), grads)


class _Shape:
    """A leaf's shape alone, for the sharding rules."""

    def __init__(self, shape):
        self.shape = tuple(shape)


def _zero_dim(pspec, ospec) -> int | None:
    """The dim the optimizer spec adds ``data`` on, or None."""
    ps = tuple(pspec) + (None,) * (len(ospec) - len(pspec))
    return next((i for i, (a, b) in enumerate(zip(tuple(ospec), ps))
                 if a == "data" and b is None), None)


class Zero1:
    """The production placement's optimizer step on one rank (ZeRO-1):
    each leaf's gradient is summed over the data axes its parameter spec
    does not split (``sharding.param_spec``), and the moments live where
    the reference's ``opt_shardings`` put them on its stacked ``[L, ...]``
    tree.  Where that adds ``data`` on a dim of the leaf, the sum is a
    reduce-scatter along it (after an all-reduce over ``pod``), the rank
    updates its slice of the parameter with its slice of the moments, and
    the slices are all-gathered over ``data``, the shape GSPMD gives.
    Where it adds ``data`` on the stacked layer dim, each data rank owns
    the moments of its block of L / data layers whole: the owner updates
    the layer's leaf and broadcasts it over ``data``, the others hold
    empty moments.  The clip's global norm sums each slice's squares over
    the axes it is split over and counts a leaf every rank holds whole
    once.  Specs come from the model's global shapes
    (``Model.init_shapes``)."""

    def __init__(self, model, mesh, fsdp_experts: bool = False):
        shapes = model.init_shapes()
        pspecs = SH.shardings_in_order(shapes, SH.params_pspecs(
            shapes, mesh, fsdp_experts=fsdp_experts))
        self.mesh = mesh
        self.data = mesh.group("data")
        dsz = SH.axis_size(mesh, "data")
        n_layers = len(shapes["layers"])
        self.plans = []
        for (path, leaf), ps in zip(T.leaves_with_path(shapes), pspecs):
            shape = tuple(leaf.shape)
            owner = zero = None
            if len(path) > 1 and path[0] == "layers":
                # the reference's stacked leaf and its moments' spec
                spath = (path[0],) + path[2:]
                sshape = (n_layers,) + shape
                sps = SH.param_spec(spath, _Shape(sshape), mesh,
                                    fsdp_experts=fsdp_experts)
                zdim = _zero_dim(sps, SH.opt_spec(sps, sshape, mesh))
                if zdim == 0:
                    owner = path[1] // (n_layers // dsz)
                elif zdim is not None:
                    zero = zdim - 1
            else:
                zero = _zero_dim(ps, SH.opt_spec(ps, shape, mesh))
            used = {a for ax in ps if ax is not None
                    for a in (ax if isinstance(ax, tuple) else (ax,))}
            sum_axes = tuple(a for a in ("pod", "data")
                             if a in mesh.axis_names and a not in used)
            split = used | ({"data"} if zero is not None or owner is not None
                            else set())
            self.plans.append((zero, owner, sum_axes, mesh.group(tuple(
                a for a in mesh.axis_names if a in split))))
        self.norm_groups = [g for *_, g in self.plans]

    def _mine(self, owner) -> bool:
        return (self.data is None
                or dist.get_rank(self.data) == owner)

    def opt_shapes(self, params) -> list:
        """The rank's moment shapes, leaf by leaf: its parameter blocks'
        shapes with the ZeRO dim cut over ``data``, or empty for a layer
        another data rank owns."""
        n = SH.axis_size(self.mesh, "data")
        idx = self.mesh.coord.get("data", 0)
        out = []
        for p, (zero, owner, _, _) in zip(T.leaves(params), self.plans):
            shape = list(p.shape)
            if zero is not None:
                shape[zero] //= n
            if owner is not None and owner != idx:
                shape[0] = 0
            out.append(tuple(shape))
        return out

    def init(self, optimizer: AdamW, params):
        """Zero moments of the rank's ZeRO-1 slices."""
        slices = T.unflatten(params, [
            torch.empty(s, dtype=p.dtype, device=p.device)
            for p, s in zip(T.leaves(params), self.opt_shapes(params))])
        return optimizer.init(slices)

    def reduce(self, grads):
        """Each leaf's gradient summed over the data axes, as the rank's
        ZeRO-1 slice where the leaf has one."""
        out = []
        for g, (zero, owner, sum_axes, _) in zip(T.leaves(grads),
                                                 self.plans):
            if zero is not None:
                if "pod" in sum_axes:
                    g = collectives.all_reduce(g.clone(),
                                               self.mesh.group("pod"))
                g = collectives.reduce_scatter_dim(g, zero, self.data)
            elif sum_axes:
                g = collectives.all_reduce(g.clone(),
                                           self.mesh.group(sum_axes))
            if owner is not None and not self._mine(owner):
                g = g[:0]
            out.append(g)
        return T.unflatten(grads, out)

    def slices(self, params):
        out = []
        for p, (zero, owner, _, _) in zip(T.leaves(params), self.plans):
            if zero is not None:
                p = collectives.block_of(p, zero, self.data).contiguous()
            elif owner is not None and not self._mine(owner):
                p = p[:0]
            out.append(p)
        return T.unflatten(params, out)

    def gather(self, params, like):
        """The updated slices made whole again: all-gathered along the
        ZeRO dim, or broadcast from a layer's owner (into ``like``'s
        leaf shapes)."""
        out = []
        for p, old, (zero, owner, _, _) in zip(T.leaves(params),
                                               T.leaves(like), self.plans):
            if zero is not None:
                p = collectives.all_gather_dim(p, zero, self.data)
            elif owner is not None and self.data is not None:
                buf = p if self._mine(owner) else torch.empty_like(old)
                p = collectives.broadcast(buf.contiguous(), owner, self.data)
            out.append(p)
        return T.unflatten(params, out)


def init_placed_state(model, optimizer: AdamW, mesh, params, *,
                      fsdp_experts: bool = False) -> TrainState:
    """A rank's train state under the production placement: ``params``
    its parameter blocks (``sharding.place``), the moments its ZeRO-1
    slices of them, step 0."""
    params = _trainable(params)
    opt = Zero1(model, mesh, fsdp_experts).init(optimizer, params)
    step = torch.zeros((), dtype=torch.int32,
                       device=T.leaves(params)[0].device)
    return TrainState(params=params, opt=opt, step=step)


def save_state(ckpt_dir: str, step: int, state: TrainState) -> str:
    return CK.save(ckpt_dir, step, state.tree())


def restore_state(ckpt_dir: str, like: TrainState, cfg,
                  step: int | None = None) -> tuple[TrainState, int]:
    """The state of a checkpoint, on ``like``'s device with its dtypes:
    one :func:`save_state` wrote, or a ``TrainState`` of the JAX trainer
    (leaf paths ``.params[...]``, ``.opt[...]``, ``.step``, ``.ef[...]``).
    Returns (state, step)."""
    if not CK.leaf_paths(ckpt_dir, step)[0].startswith("."):
        tree, step, _ = CK.restore(ckpt_dir, like.tree(), step=step)
        tree["params"] = _trainable(tree["params"])
        return TrainState(**tree), step
    step = step if step is not None else CK.latest_step(ckpt_dir)
    j = CK.nest(CK.restore_numpy(ckpt_dir, step))
    dev = like.step.device
    m_dtype = T.leaves(like.opt["m"])[0].dtype

    def params(tree, dtype=torch.float32):
        return params_from_jax(tree, cfg, device=dev, dtype=dtype)

    state = TrainState(
        params=_trainable(params(j["params"])),
        opt={"m": params(j["opt"]["m"], m_dtype),
             "v": params(j["opt"]["v"], m_dtype),
             "count": torch.as_tensor(j["opt"]["count"], device=dev)},
        step=torch.as_tensor(j["step"], device=dev),
        ef=params(j["ef"]) if "ef" in j else None)
    return state, step


def make_train_step(model, optimizer: AdamW, ctx: Ctx, *,
                    grad_accum: int = 1, compress_grads: bool = False,
                    compress_block: int = 2048):
    """Build ``train_step(state, batch) -> (state, metrics)``.

    ``grad_accum`` > 1 splits the batch on the leading dim into
    micro-batches run one after another; their gradients and losses are
    summed, then divided by ``grad_accum``.  ``compress_grads`` applies
    int8 + error-feedback compression to the accumulated gradient (the
    numerics of the compressed all-reduce's wire format).  Under the
    production placement (``ctx.placement``) the state is the rank's
    (:func:`init_placed_state`) and the optimizer step is :class:`Zero1`'s."""
    zero = Zero1(model, ctx.mesh, ctx.moe_fsdp) if ctx.placed else None
    if zero is not None and compress_grads:
        raise NotImplementedError("gradient compression under the "
                                  "production placement")

    def grad_fn(params, mb):
        """(loss, grads); a parameter the loss does not reach gets zeros,
        as under ``jax.grad``."""
        leaves = T.leaves(params)
        loss, _ = model.loss(params, mb, ctx)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), T.unflatten(params, grads)

    def train_step(state: TrainState, batch):
        if grad_accum == 1:
            loss, grads = grad_fn(state.params, batch)
        else:
            micro = T.map(lambda x: x.reshape(
                (grad_accum, x.shape[0] // grad_accum) + tuple(x.shape[1:])),
                batch)
            grads = T.map(torch.zeros_like, state.params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=state.step.device)
            for i in range(grad_accum):
                mb = T.map(lambda x: x[i], micro)
                l, g = grad_fn(state.params, mb)
                grads = T.map(torch.add, grads, g)
                loss = loss + l
            grads = T.map(lambda g: g / grad_accum, grads)
            loss = loss / grad_accum

        ef = state.ef
        if zero is not None:
            with torch.no_grad():
                slices, opt, opt_metrics = optimizer.update(
                    zero.reduce(grads), state.opt,
                    zero.slices(state.params), zero.norm_groups)
                params = zero.gather(slices, state.params)
            new_state = TrainState(params=_trainable(params), opt=opt,
                                   step=state.step + 1, ef=ef)
            return new_state, {"loss": loss, **opt_metrics}
        if ctx.mesh is not None:
            grads = sync_grads(grads, ctx)
        if compress_grads:
            grads, ef = collectives.ef_compress(grads, ef, compress_block)

        with torch.no_grad():
            params, opt, opt_metrics = optimizer.update(grads, state.opt,
                                                        state.params)
        new_state = TrainState(params=_trainable(params), opt=opt,
                               step=state.step + 1, ef=ef)
        out = {"loss": loss, **opt_metrics}
        return new_state, out

    return train_step


def make_eval_step(model, ctx: Ctx):
    """``eval_step(params, batch) -> {"loss", "xent", "aux"}``, computed
    without autograd, so every backend (``cuda`` too) can evaluate."""
    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = model.loss(params, batch, ctx)
        return {"loss": loss, **metrics}
    return eval_step
