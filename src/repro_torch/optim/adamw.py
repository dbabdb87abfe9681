"""AdamW, a cosine schedule and global-norm clipping as plain tensor code.

Counterpart of ``repro.optim.adamw``, functional like it: ``init(params)``
and ``update(grads, state, params) -> (params, state, metrics)`` over the
port's parameter trees (``repro_torch.tree``).  Not ``torch.optim.AdamW``:
torch decays the weights as ``p *= 1 - lr * wd`` before the step, the
reference adds ``wd * p`` to the step, and the two round differently.
The moments may live in a lower precision (``state_dtype``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import tree as T


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1):
    """Linear warmup then cosine decay to ``final_frac * base_lr``; the
    returned ``lr(step)`` gives a float32 tensor on ``step``'s device."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


def global_norm(tree, groups=None) -> torch.Tensor:
    """The L2 norm of all the tree's leaves together.  ``groups``: per
    leaf (in leaf order) the process group its block is split over, or
    None for a leaf every rank holds whole; each group's leaves' squares
    are then summed over it, so each element counts once, and every rank
    gets the norm of the whole tree."""
    sq = [torch.sum(torch.square(x.to(torch.float32))) for x in T.leaves(tree)]
    if groups is None:
        return torch.sqrt(torch.sum(torch.stack(sq)))
    from repro_torch.distributed.collectives import all_reduce
    parts = []
    for g in dict.fromkeys(groups):     # each group once, in first-use order
        part = torch.sum(torch.stack([q for q, gq in zip(sq, groups,
                                                          strict=True)
                                      if gq is g]))
        parts.append(all_reduce(part, g))
    return torch.sqrt(torch.sum(torch.stack(parts)))


def _clip(tree, max_norm: float, norm):
    """``tree`` scaled so that its global norm ``norm`` is at most
    ``max_norm``."""
    # a true division: torch's ``float / tensor`` multiplies by a reciprocal
    scale = torch.clamp(torch.full_like(norm, max_norm)
                        / torch.clamp(norm, min=1e-9), max=1.0)
    return T.map(lambda x: (x * scale).to(x.dtype), tree)


def clip_by_global_norm(tree, max_norm: float):
    """(``tree`` scaled so its global norm is at most ``max_norm``, the
    norm before clipping)."""
    norm = global_norm(tree)
    return _clip(tree, max_norm, norm), norm


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Any = 1e-3                  # float or callable(step) -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    max_grad_norm: float | None = 1.0
    state_dtype: torch.dtype = torch.float32

    def init(self, params):
        """``{"m", "v"}`` zeros shaped like ``params`` and ``count``, a 0-d
        int32 tensor on the parameters' device."""
        def zeros(p):
            return torch.zeros(p.shape, dtype=self.state_dtype,
                               device=p.device)

        dev = T.leaves(params)[0].device
        return {"m": T.map(zeros, params), "v": T.map(zeros, params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(self, grads, state, params, norm_groups=None):
        """Returns (new_params, new_state, metrics).  ``norm_groups``: the
        leaves' groups for the global norm (:func:`global_norm`), where
        each rank holds blocks of them (ZeRO-1, tensor parallelism)."""
        count = state["count"] + 1
        gnorm = global_norm(grads, norm_groups)
        if self.max_grad_norm is not None:
            grads = _clip(grads, self.max_grad_norm, gnorm)
        lr = (self.lr(count) if callable(self.lr)
              else torch.tensor(self.lr, dtype=torch.float32,
                                device=count.device))
        b1, b2 = self.b1, self.b2
        c = count.to(torch.float32)
        bias1 = 1 - torch.pow(b1, c)
        bias2 = 1 - torch.pow(b2, c)

        def upd(p, g, m, v):
            g32 = g.to(torch.float32)
            m_new = b1 * m.to(torch.float32) + (1 - b1) * g32
            v_new = b2 * v.to(torch.float32) + (1 - b2) * g32 * g32
            mh = m_new / bias1
            vh = v_new / bias2
            step = mh / (torch.sqrt(vh) + self.eps)
            if self.weight_decay:
                step = step + self.weight_decay * p.to(torch.float32)
            p_new = p.to(torch.float32) - lr * step
            return (p_new.to(p.dtype), m_new.to(self.state_dtype),
                    v_new.to(self.state_dtype))

        out = [upd(*xs) for xs in zip(
            T.leaves(params), T.leaves(grads), T.leaves(state["m"]),
            T.leaves(state["v"]), strict=True)]
        new_state = {"m": T.unflatten(params, (o[1] for o in out)),
                     "v": T.unflatten(params, (o[2] for o in out)),
                     "count": count}
        return (T.unflatten(params, (o[0] for o in out)), new_state,
                {"grad_norm": gnorm, "lr": lr})
