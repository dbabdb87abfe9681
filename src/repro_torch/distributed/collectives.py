"""Collectives of the multi-device path and the numerics of the
compressed gradient all-reduce.

Counterpart of ``repro.distributed.collectives``:

1. ``int8_quantize``/``int8_dequantize``, ``compression_ratio``,
   ``ef_init`` and ``ef_compress`` (int8 + error feedback, which
   ``training.train_step`` applies under ``compress_grads``).  Both
   packages round half to even, so the int8 words and scales are
   bit-identical.
2. ``compressed_psum``/``compressed_pmean``: the int8 all-reduce over a
   process group (the reference's runs inside ``shard_map`` over a mesh
   axis): quantize locally, agree on the max scale, requantize, sum the
   int32 words exactly, dequantize.
3. ``bucketed``: the leaves of a tree grouped into buckets of about
   ``bucket_bytes``, the plan :func:`all_reduce_tree` issues one
   all-reduce per bucket by.
4. The autograd-aware collectives of the data-, expert- and
   tensor-parallel paths: :func:`reduce_sum` (the group's sum; each
   rank's gradient is its own share), :func:`copy_sum_grad` (identity;
   the gradient summed over the group), :func:`gather_dim` (the ZeRO-3
   all-gather along a dim; its gradient reduce-scattered), and for the
   production placement's model axis :func:`gather_replicated` (the
   all-gather before a computation every model rank runs alike; its
   gradient cut to the rank's block) and :func:`take_block` (the rank's
   block; its gradient all-gathered).  :func:`all_gather_dim` and
   :func:`reduce_scatter_dim` are the plain collectives (ZeRO-1).
5. :func:`on_every_rank`: marks a block that every rank of a mesh runs
   on its own shapes (the reference's ``shard_map`` body), which the cost
   model (``analysis.costmodel``) counts that many times.

Every collective here goes through :func:`_issue`, which counts its
payload bytes by kind in ``BYTES`` and, inside :func:`recording`, each
call's result bytes and group size by the reference's HLO names.  This module hands the tensors to
the process group where they are: gloo of the port's PyTorch takes CUDA
tensors for every kind used here (all-reduce, broadcast, all-gather,
reduce-scatter), so the port stages nothing through host memory itself.
gloo's transport is the host, though: it copies a CUDA tensor to host
memory and back inside each collective, so on a gloo group every byte
counted here crosses host memory.  NCCL groups keep them on the cards.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

from repro_torch import tree as T


def int8_quantize(x, block: int = 2048):
    """Symmetric per-block int8 quantization.  Returns (q, scales, meta)."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    amax = torch.amax(torch.abs(blocks), dim=1, keepdim=True)
    # a tensor divisor: CUDA divides by a host scalar as a multiply by its
    # reciprocal, which rounds differently
    scale = torch.clamp(amax, min=1e-30) / amax.new_tensor(127.0)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32), (tuple(x.shape), n)


def int8_dequantize(q, scale, meta):
    shape, n = meta
    out = (q.to(torch.float32) * scale).reshape(-1)[:n]
    return out.reshape(shape)


def compression_ratio(x, block: int = 2048) -> float:
    """Wire bytes of compressed vs f32 transfer (int8 payload + f32 scales)."""
    n = x.numel()
    nb = -(-n // block)
    return (n + 4 * nb) / (4 * n)


def ef_init(grads):
    """Zero residual buffer matching the gradient tree."""
    return T.map(torch.zeros_like, grads)


def ef_compress(grads, ef, block: int = 2048):
    """int8 quantization with error feedback over a gradient tree: returns
    (compressed grads, new residual).  The residual, what int8 could not
    represent, is carried into the next step."""
    comp, new_ef = [], []
    for g, e in zip(T.leaves(grads), T.leaves(ef), strict=True):
        tot = g + e
        deq = int8_dequantize(*int8_quantize(tot, block))
        comp.append(deq)
        new_ef.append(tot - deq)
    return T.unflatten(grads, comp), T.unflatten(grads, new_ef)


# --------------------------------------------------------------------------
# Collectives over a process group
# --------------------------------------------------------------------------

# payload bytes issued by kind (each rank's input, as the wire sees it)
BYTES = {"all_reduce": 0, "broadcast": 0, "all_gather": 0,
         "reduce_scatter": 0}

# the reference's HLO name of each kind (``launch.dryrun``'s record)
HLO_NAMES = {"all_reduce": "all-reduce", "all_gather": "all-gather",
             "reduce_scatter": "reduce-scatter", "broadcast": "broadcast"}
_RECORDS: list = []


def reset_bytes() -> None:
    for k in BYTES:
        BYTES[k] = 0


@contextlib.contextmanager
def recording():
    """Record every collective issued inside, the counterpart of the
    reference's HLO collectives (``launch.dryrun.parse_collectives``):
    yields a dict of the HLO names ``all-reduce``, ``all-gather``,
    ``reduce-scatter``, ``all-to-all`` and ``collective-permute`` (and
    ``broadcast`` where one was issued), each with ``count``, ``bytes``
    (the result's bytes on this rank), ``bytes_effective`` (the same: a
    loop issues its collectives once per trip) and ``max_group``, filled
    in when the block ends."""
    out = {k: {"count": 0, "bytes": 0, "bytes_effective": 0, "max_group": 0}
           for k in ("all-reduce", "all-gather", "reduce-scatter",
                     "all-to-all", "collective-permute")}
    rec: dict = {}
    _RECORDS.append(rec)
    try:
        yield out
    finally:
        _RECORDS.remove(rec)
        for (kind, group_n), (count, nbytes) in rec.items():
            o = out.setdefault(HLO_NAMES[kind], {
                "count": 0, "bytes": 0, "bytes_effective": 0,
                "max_group": 0})
            o["count"] += count
            o["bytes"] += nbytes
            o["bytes_effective"] += nbytes
            o["max_group"] = max(o["max_group"], group_n)


def _issue(kind: str, t: torch.Tensor, fn, group=None, out_bytes=None):
    nbytes = t.numel() * t.element_size()
    BYTES[kind] += nbytes
    if _RECORDS:
        n = dist.get_world_size(group)
        key = (kind, n)
        res = nbytes if out_bytes is None else out_bytes
        for rec in _RECORDS:
            count, total = rec.get(key, (0, 0))
            rec[key] = (count + 1, total + res)
    fn()


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over ``group`` in place (returned); a no-op where the
    group is None (one rank)."""
    if group is not None:
        _issue("all_reduce", x, lambda: dist.all_reduce(x, op=op, group=group),
               group)
    return x


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def compressed_psum(x, group=None, block: int = 2048):
    """All-reduce ``x`` over ``group`` in int8: each rank quantizes its
    tensor, the ranks agree on the max scale per block, the requantized
    int32 words are summed exactly (no overflow below 2^23 ranks) and
    dequantized with the shared scale.  The mean is the caller's."""
    q, scale, meta = int8_quantize(x, block)
    scale_max = all_reduce(scale.clone(), group, dist.ReduceOp.MAX)
    requant = torch.clamp(torch.round(q.to(torch.float32)
                                      * (scale / scale_max)),
                          -127, 127).to(torch.int32)
    return int8_dequantize(all_reduce(requant, group), scale_max, meta)


def compressed_pmean(x, group=None, block: int = 2048):
    out = compressed_psum(x, group, block)
    return out / out.new_tensor(float(group_size(group)))


def bucketed(tree, bucket_bytes: int = 64 << 20) -> list[list[tuple]]:
    """The tree's leaf paths (``tree.leaves_with_path``, JAX's order) in
    buckets: a bucket closes once its f32 bytes reach ``bucket_bytes``."""
    buckets, cur, cur_b = [], [], 0
    for path, leaf in T.leaves_with_path(tree):
        cur.append(path)
        cur_b += leaf.numel() * 4
        if cur_b >= bucket_bytes:
            buckets.append(cur)
            cur, cur_b = [], 0
    if cur:
        buckets.append(cur)
    return buckets


def all_reduce_tree(tree, group, bucket_bytes: int = 64 << 20):
    """The tree's leaves summed over ``group``, one all-reduce per
    :func:`bucketed` bucket of leaves of one dtype (a new tree)."""
    if group is None:
        return tree
    flat = T.leaves(tree)
    out, i = [], 0
    for bucket in bucketed(tree, bucket_bytes):
        leaves = flat[i:i + len(bucket)]
        i += len(bucket)
        for dtype in dict.fromkeys(x.dtype for x in leaves):
            same = [x for x in leaves if x.dtype == dtype]
            buf = all_reduce(torch.cat([x.reshape(-1) for x in same]), group)
            parts = iter(buf.split([x.numel() for x in same]))
            done = {id(x): next(parts).view(x.shape) for x in same}
            leaves = [done.get(id(x), x) for x in leaves]
        out.extend(leaves)
    return T.unflatten(tree, out)


def broadcast_tree(tree, src: int = 0, group=None,
                   bucket_bytes: int = 64 << 20):
    """Every leaf overwritten in place with rank ``src``'s (a global
    rank), in buckets of one dtype."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return tree
    flat = T.leaves(tree)
    i = 0
    for bucket in bucketed(tree, bucket_bytes):
        leaves = flat[i:i + len(bucket)]
        i += len(bucket)
        for dtype in dict.fromkeys(x.dtype for x in leaves):
            same = [x for x in leaves if x.dtype == dtype]
            buf = torch.cat([x.detach().reshape(-1) for x in same])
            _issue("broadcast", buf,
                   lambda: dist.broadcast(buf, src, group=group), group)
            with torch.no_grad():
                for x, part in zip(same, buf.split([x.numel()
                                                    for x in same])):
                    x.copy_(part.view(x.shape))
    return tree


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopySumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``.  Its gradient passes to each
    rank's ``x`` unchanged: every rank's gradient is its own share of the
    sum's, so summing the ranks' parameter gradients afterwards gives the
    gradient of the sum (the reference's GSPMD reduction)."""
    return x if group is None else _ReduceSum.apply(x, group)


def copy_sum_grad(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; its gradient summed over ``group``: the input of a
    block whose ranks each compute part of a sum (:func:`reduce_sum`)
    from the same ``x``."""
    return x if group is None else _CopySumGrad.apply(x, group)


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim`` in
    group-rank order (no autograd)."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    _issue("all_gather", xt, lambda: dist.all_gather_into_tensor(
        out, xt, group=group), group, out.numel() * out.element_size())
    return out.movedim(0, dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x`` summed over ``group``, of which this rank keeps its block
    along ``dim`` (no autograd)."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    _issue("reduce_scatter", xt, lambda: dist.reduce_scatter_tensor(
        out, xt, group=group), group, out.numel() * out.element_size())
    return out.movedim(0, dim)


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` overwritten in place with the group's rank ``src``'s (a rank
    within the group; returned; no autograd)."""
    if group is not None:
        root = dist.get_global_rank(group, src)
        _issue("broadcast", x, lambda: dist.broadcast(x, root, group=group),
               group)
    return x


def block_of(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim``: one of as many equal
    blocks as ``group`` has ranks, in group-rank order."""
    if group is None:
        return x
    n = x.shape[dim] // dist.get_world_size(group)
    return x.narrow(dim, dist.get_rank(group) * n, n)


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return block_of(g, ctx.dim, ctx.group).contiguous(), None, None


class _TakeBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return block_of(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.group), None, None


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' blocks of ``x`` concatenated along ``dim`` in group-rank
    order (the ZeRO-3 weight gather); its gradient is reduce-scattered
    back, each rank keeping the group's summed gradient of its block."""
    return x if group is None else _GatherDim.apply(x, dim, group)


def gather_replicated(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' blocks of ``x`` concatenated along ``dim``, for a
    computation every rank of ``group`` then runs alike (a column-parallel
    projection's output gathered before the head reshape): its gradient,
    the whole one on every rank, is cut back to the rank's block."""
    return x if group is None else _GatherReplicated.apply(x, dim, group)


def take_block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` of a tensor every rank of ``group``
    holds alike (the input of a row-parallel projection): its gradient is
    gathered back, so each rank holds the whole tensor's gradient, as it
    holds the tensor."""
    return x if group is None else _TakeBlock.apply(x, dim, group)


_TLS = threading.local()


def ranks_running() -> int:
    """How many ranks run the ops issued here, each on its own shapes
    (1 outside :func:`on_every_rank`)."""
    return getattr(_TLS, "ranks", 1)


@contextlib.contextmanager
def on_every_rank(n: int):
    """Mark the ops issued inside as a block that each of ``n`` ranks runs
    on its own shapes (nesting multiplies), as the reference's
    ``shard_map`` body runs on every device of its mesh."""
    prev = ranks_running()
    _TLS.ranks = prev * n
    try:
        yield
    finally:
        _TLS.ranks = prev
