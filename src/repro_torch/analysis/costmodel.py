"""Cost model: the FLOPs and bytes of the aten ops a function dispatches.

Counterpart of ``repro.analysis.costmodel``.  The reference walks a traced
jaxpr and multiplies ``scan`` bodies by their trip counts, because XLA's
``cost_analysis`` counts a loop body once.  Here loops run in Python, so a
``TorchDispatchMode`` counts every aten op as it is dispatched: a loop's
body is counted once per trip, and a ``torch.utils.checkpoint`` region is
counted again when the backward pass recomputes it (ops whose outputs a
selective-checkpoint policy saved are not dispatched again, so they are
not counted again).

Counted, at the reference's definitions:
  * ``dot_flops``: 2 * batch * M * N * K per mm / bmm / addmm / baddbmm /
    addbmm, and a convolution as the dot it is (2 * output elements *
    input channels per group * kernel size);
  * ``dot_traffic``: operand bytes + 4 * batch * M * N (an f32 output) per
    dot: a fusion-free upper bound on the matmuls' memory traffic;
  * ``dots``: the number of such ops dispatched.  The reference counts a
    jaxpr's dot equations, each once however often its scan runs it; here
    each execution counts, so under a loop the two differ by the trip
    count (``dot_flops`` and ``dot_traffic`` agree);
  * ``ew_flops``: one per output element of the arithmetic ops in
    ``ATEN_TO_PRIMITIVE``, the aten counterparts of the reference's
    ``_ARITH`` primitives.  Where one aten op stands for several
    primitives (``mean`` is ``reduce_sum`` and ``div``; ``addmm``'s bias
    is an ``add``) it counts once per primitive.  Fused aten ops that
    have no counterpart there (``tanh_backward``, ``clamp``, softmax) are
    not counted, so backward passes and some forward ops differ from the
    reference's counts.

``analyze(fn, *args)`` takes real tensors or ``meta`` tensors (the
counterpart of ``jax.ShapeDtypeStruct``: shapes and dtypes, nothing
computed).  ``analyze_graph`` counts an aten graph already traced with
``make_fx``, as the reference's ``analyze_jaxpr`` walks a jaxpr.

The reference multiplies a ``shard_map`` body's counts by the mesh size:
its shapes are one device's, and every device runs it.  Here an op counts
``distributed.collectives.ranks_running()`` times: the expert-parallel
block of ``models.layers.moe_apply`` runs inside
``collectives.on_every_rank(mesh size)``, so ``analyze`` on one rank of a
mesh reports the global program's dot FLOPs for it (``dots`` still counts each op
once, as the reference counts each equation once).

Model FLOPs are counted on the ``exact`` backend, where every projection
is one dot.  A custom CUDA launch (the ``cuda`` backend's encode and
logmac kernels) does not pass through the dispatcher and is invisible to
this mode, and the ``lax_ref`` engine runs two dots per contraction (the
val and rem planes), so neither counts the model's own FLOPs.
"""
from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.distributed.collectives import ranks_running

aten = torch.ops.aten

# aten op (overload packet) -> the reference's ``_ARITH`` primitives it
# stands for, each counted once per output element
ATEN_TO_PRIMITIVE = {
    aten.add: ("add",), aten.sub: ("sub",), aten.rsub: ("sub",),
    aten.mul: ("mul",), aten.div: ("div",), aten.maximum: ("max",),
    aten.minimum: ("min",), aten.exp: ("exp",), aten.log: ("log",),
    aten.tanh: ("tanh",), aten.rsqrt: ("rsqrt",), aten.sqrt: ("sqrt",),
    aten.neg: ("neg",), aten.abs: ("abs",), aten.floor: ("floor",),
    aten.round: ("round",), aten.sign: ("sign",), aten.sigmoid: ("logistic",),
    aten.pow: ("integer_pow",), aten.erf: ("erf",), aten.cumsum: ("cumsum",),
    aten.sum: ("reduce_sum",), aten.mean: ("reduce_sum", "div"),
    aten.amax: ("reduce_max",), aten.max: ("reduce_max",),
    aten.where: ("select_n",), aten.bitwise_and: ("and",),
    aten.bitwise_or: ("or",), aten.bitwise_xor: ("xor",),
    aten.bitwise_left_shift: ("shift_left",),
    aten.bitwise_right_shift: ("shift_right_arithmetic",),
    aten.lt: ("lt",), aten.le: ("le",), aten.gt: ("gt",), aten.ge: ("ge",),
    aten.eq: ("eq",), aten.ne: ("ne",),
}

_MM = {aten.mm, aten.addmm}
_BMM = {aten.bmm, aten.baddbmm, aten.addbmm}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _numel(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel()
    if isinstance(out, (tuple, list)) and out and isinstance(
            out[0], torch.Tensor):
        return out[0].numel()
    return 0


def _dot_cost(packet, args, out) -> tuple[int, int] | None:
    """(flops, traffic) of a dot-shaped aten op, None for any other."""
    if packet in _MM or packet in _BMM:
        a, b = (args[1], args[2]) if packet in (aten.addmm, aten.baddbmm,
                                               aten.addbmm) else args[:2]
        K = a.shape[-1]
        nb = a.shape[0] if a.ndim == 3 else 1
        M, N = a.shape[-2], b.shape[-1]
        return 2 * nb * M * N * K, _nbytes(a) + _nbytes(b) + 4 * nb * M * N
    if packet is aten.convolution:
        x, w, groups = args[0], args[1], args[8]
        per_out = (x.shape[1] // groups) * math.prod(w.shape[2:])
        return 2 * out.numel() * per_out, (_nbytes(x) + _nbytes(w)
                                           + 4 * out.numel())
    return None


def _zero() -> dict:
    return {"dot_flops": 0.0, "ew_flops": 0.0, "dot_traffic": 0.0, "dots": 0}


def _count(acc: dict, func, args, out, mult: int = 1) -> None:
    """Add one aten op's counts, ``mult`` times, to ``acc``."""
    packet = getattr(func, "overloadpacket", func)
    dot = _dot_cost(packet, args, out)
    if dot is not None:
        flops, traffic = dot
        acc["dot_flops"] += flops * mult
        acc["dot_traffic"] += traffic * mult
        acc["dots"] += 1
        if packet in (aten.addmm, aten.baddbmm, aten.addbmm):
            acc["ew_flops"] += _numel(out) * mult       # the bias add
    elif packet in ATEN_TO_PRIMITIVE:
        acc["ew_flops"] += (_numel(out) * len(ATEN_TO_PRIMITIVE[packet])
                            * mult)


class CostMode(TorchDispatchMode):
    """Accumulates the reference's four counts over the aten ops
    dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.counts = _zero()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        _count(self.counts, func, args, out, ranks_running())
        return out


def analyze(fn, *args) -> dict:
    """Run ``fn(*args)`` under :class:`CostMode` and return its counts:
    ``dot_flops``, ``ew_flops``, ``dot_traffic`` and ``dots``."""
    with CostMode() as mode:
        fn(*args)
    return mode.counts


def analyze_graph(graph, acc=None) -> dict:
    """The counts of an aten-level ``torch.fx`` graph (``make_fx(fn)(*args)
    .graph``), from each node's recorded output (``meta["val"]``): the
    counterpart of the reference's ``analyze_jaxpr`` walk of a traced
    program.  Python loops are unrolled in such a graph, so each trip is
    a node of its own."""
    acc = _zero() if acc is None else acc

    def val(a):
        return a.meta.get("val") if isinstance(a, torch.fx.Node) else a

    for node in graph.nodes:
        if node.op == "call_function":
            _count(acc, node.target, [val(a) for a in node.args],
                   node.meta.get("val"))
    return acc
