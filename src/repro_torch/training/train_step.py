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
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

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
    also over the model group (a model rank's hold its experts' rows)."""
    grads = collectives.all_reduce_tree(grads, ctx.data_group, bucket_bytes)
    mg = ctx.model_group
    if mg is None:
        return grads
    return T.map_with_path(
        lambda path, g: (collectives.all_reduce(g.clone(), mg)
                         if _is_expert_stack(path, g) else g), grads)


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
    numerics of the compressed all-reduce's wire format)."""

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

        if ctx.mesh is not None:
            grads = sync_grads(grads, ctx)
        ef = state.ef
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
