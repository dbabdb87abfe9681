"""Sharding rules: parameter / optimizer / data / cache partition specs.

Counterpart of ``repro.distributed.sharding``: the same rules as pure
functions, with the same results for the same tree and mesh.  A mesh is
anything with ``.shape`` (axis name -> size) and ``.axis_names``: a
:class:`repro_torch.launch.mesh.Mesh`, or a stand-in for a mesh that was
never launched (the rules need no process).

Mesh layout (``launch/mesh.py``): single-pod ``("data", "model")`` =
(16, 16); multi-pod ``("pod", "data", "model")`` = (2, 16, 16).

Parameter rules (Megatron-style over ``model``):
  * embed [V, d] -> (model, None), vocab-sharded
  * attention wq/wk/wv -> (None, model); wo -> (model, None)
  * mlp wi/wg -> (None, model); wo -> (model, None)
  * MoE expert stacks [E, d, f] -> (model, None, opt-data): experts over
    ``model``; with ``fsdp_experts`` the ``f`` dim also over
    (``pod``, ``data``), the ZeRO-3 storage of arctic-480b
  * SSD in_proj (None, model) / out_proj (model, None); A_log, D, dt_bias
    over model when divisible
  * norms / biases / router -> replicated

The reference stacks a model's layers ``[L, ...]`` and never shards the
leading dim; the port keeps a list of per-layer trees, whose paths carry
the layer's index (``("layers", 3, "attn", "wq", "w")``), and there the
rules apply to the whole leaf.  A stacked tree (the reference's, as
numpy) gets the reference's specs.

Optimizer state mirrors the parameter specs, with a ZeRO-1 extension: the
first unsharded dim of every >= 2-D state also shards over ``data`` when
divisible.

The reference's ``NamedSharding`` trees place arrays; here
:func:`local_shard` cuts one rank's block out of a global tensor under a
spec, :func:`local_shards` does it over a tree of (mesh, spec) pairs,
which is what ``params_shardings``, ``opt_shardings``,
``batch_shardings`` and ``cache_shardings`` return, and :func:`place`
over a tree of specs (``params_pspecs``): the tree a rank holds under
``models.layers.Ctx(placement="production")``.  :func:`local_shape` and
:func:`global_shape` map a leaf's shape between the two sides of a spec.
"""
from __future__ import annotations

import math
import re
from typing import Any

from repro_torch import tree as T


class PartitionSpec(tuple):
    """One entry per dimension: None, an axis name or a tuple of axis
    names.  A tuple, so it compares equal to the reference's entries; a
    tuple of one name is that name and an empty one None, as JAX's
    ``PartitionSpec`` keeps them."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            (e[0] if len(e) == 1 else e or None) if isinstance(e, tuple)
            else e for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"

    def __getnewargs__(self):     # unpickle entry by entry
        return tuple(self)


P = PartitionSpec


def axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def _shape(leaf) -> tuple:
    return tuple(leaf.shape)


def data_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_size(mesh) -> int:
    return math.prod(axis_size(mesh, a) for a in ("pod", "data"))


# --------------------------------------------------------------------------
# Parameter rules
# --------------------------------------------------------------------------

_COL = re.compile(r"(wq|wk|wv|wi|wg|in_proj)$")
_ROW = re.compile(r"(wo|out_proj)$")


def _path_names(path) -> list[str]:
    """Key names of a path: the port's str keys and int indices, or the
    reference's key objects (``.key``, ``.name``)."""
    out = []
    for k in path:
        if hasattr(k, "key"):
            out.append(str(k.key))
        elif hasattr(k, "name"):
            out.append(str(k.name))
        else:
            out.append(str(k))
    return out


def _layer_indexed(path) -> bool:
    """Whether the path enters one layer of a list of layers."""
    ks = list(path)
    return any(k == "layers" and i + 1 < len(ks) and isinstance(ks[i + 1], int)
               for i, k in enumerate(ks))


def param_spec(path, leaf, mesh, *, fsdp_experts: bool = False,
               stacked: bool = True) -> P:
    """PartitionSpec of one parameter leaf, given its tree path."""
    names = _path_names(path)
    ndim = len(_shape(leaf))
    shape = _shape(leaf)
    msz = axis_size(mesh, "model")
    in_layers = "layers" in names
    lead = 1 if (stacked and in_layers and not _layer_indexed(path)) else 0

    def spec(*tail):
        full = (None,) * lead + tail
        full = full + (None,) * (ndim - len(full))
        # drop axes missing from the mesh, then assignments that don't divide
        clean = []
        for dim, ax in enumerate(full[:ndim]):
            if ax is None:
                clean.append(None)
                continue
            axes = tuple(a for a in (ax if isinstance(ax, tuple) else (ax,))
                         if a in mesh.axis_names)
            if not axes:
                clean.append(None)
                continue
            ax = axes if isinstance(ax, tuple) else axes[0]
            sz = math.prod(axis_size(mesh, a) for a in axes)
            clean.append(ax if shape[dim] % sz == 0 else None)
        return P(*clean)

    if "embed" in names:
        return spec("model", None)
    if "moe" in names:
        if names[-1] == "w" and ndim - lead == 3:  # [E, d, f] expert stack
            f_ax = ("pod", "data") if fsdp_experts else None
            if "wo" in names:
                return spec("model", f_ax, None)
            return spec("model", None, f_ax)
        if "router" in names:
            return spec(None)
    # dense / attention / ssm projections: the enclosing module's name
    for nm in reversed(names):
        if _COL.search(nm):
            return spec(None, "model")
        if _ROW.search(nm):
            return spec("model", None)
    if names[-1] in ("A_log", "D", "dt_bias") and ndim - lead == 1:
        return spec("model" if shape[lead] % msz == 0 else None)
    return P(*((None,) * ndim))


def params_pspecs(params, mesh, *, fsdp_experts: bool = False):
    """The spec of every parameter leaf, in the tree's structure (specs
    are tuples: read them with the parameters' structure, as
    :func:`shardings_in_order` does)."""
    return T.map_with_path(
        lambda path, leaf: param_spec(path, leaf, mesh,
                                      fsdp_experts=fsdp_experts), params)


def params_shardings(params, mesh, *, fsdp_experts: bool = False):
    """(mesh, spec) per parameter leaf."""
    return T.map_with_path(
        lambda path, leaf: (mesh, param_spec(path, leaf, mesh,
                                             fsdp_experts=fsdp_experts)),
        params)


# --------------------------------------------------------------------------
# Optimizer-state rules (ZeRO-1 extension)
# --------------------------------------------------------------------------

def opt_spec(pspec: P, shape, mesh, zero1: bool = True) -> P:
    """Optimizer-moment spec: parameter spec + shard first free dim on data."""
    if not zero1 or len(shape) == 0:
        return pspec
    used = set()
    for ax in pspec:
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            used.add(a)
    if "data" in used:
        return pspec
    dsz = axis_size(mesh, "data")
    tail = list(pspec) + [None] * (len(shape) - len(pspec))
    for i, ax in enumerate(tail):
        if ax is None and shape[i] % dsz == 0 and shape[i] >= dsz:
            tail[i] = "data"
            break
    return P(*tail)


def opt_shardings(params, mesh, *, fsdp_experts: bool = False,
                  zero1: bool = True):
    def one(path, leaf):
        ps = param_spec(path, leaf, mesh, fsdp_experts=fsdp_experts)
        return (mesh, opt_spec(ps, _shape(leaf), mesh, zero1))
    return T.map_with_path(one, params)


# --------------------------------------------------------------------------
# Data / activation / cache rules
# --------------------------------------------------------------------------

def batch_spec(mesh, extra_dims: int = 1, batch_size: int | None = None) -> P:
    """[B, ...] inputs: batch over (pod, data) when divisible."""
    da = data_axes(mesh)
    if da and batch_size is not None:
        if batch_size % math.prod(axis_size(mesh, a) for a in da) != 0:
            da = ()
    return P(da if da else None, *([None] * extra_dims))


def batch_shardings(mesh, batch_tree):
    def one(leaf):
        shp = _shape(leaf)
        return (mesh, batch_spec(mesh, len(shp) - 1, shp[0] if shp else None))
    return T.map(one, batch_tree)


def cache_spec(mesh, shape, batch_dim: int = 1, seq_dim: int = 2,
               kv_dim: int | None = 3) -> P:
    """Stacked [L, B, S, KV, hd] KV cache (or [L, B, ...] state).

    Preference order: shard B over (pod, data) when divisible; shard KV
    over model when divisible; else shard S over model (the long-context
    single-sample case); else replicate."""
    nd = len(shape)
    spec: list[Any] = [None] * nd
    da = data_axes(mesh)
    dsz = math.prod(axis_size(mesh, a) for a in da) if da else 1
    if da and shape[batch_dim] % dsz == 0 and shape[batch_dim] >= dsz:
        spec[batch_dim] = da
    msz = axis_size(mesh, "model")
    if (kv_dim is not None and kv_dim < nd and shape[kv_dim] % msz == 0
            and shape[kv_dim] >= msz):
        spec[kv_dim] = "model"
    elif seq_dim < nd and shape[seq_dim] % msz == 0 and shape[seq_dim] > msz:
        spec[seq_dim] = "model"
    return P(*spec)


def cache_shardings(mesh, cache_tree):
    def one(path, leaf):
        names = _path_names(path)
        shape = _shape(leaf)
        if names[-1] in ("k", "v"):
            return (mesh, cache_spec(mesh, shape))
        if names[-1] == "state":  # [L, B, H, N, P]
            return (mesh, cache_spec(mesh, shape, kv_dim=2,
                                     seq_dim=len(shape)))
        return (mesh, cache_spec(mesh, shape, kv_dim=None,
                                 seq_dim=len(shape)))
    return T.map_with_path(one, cache_tree)


def replicated(mesh):
    return (mesh, P())


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------

def local_shard(x, spec, mesh, coord: dict | None = None):
    """The block of the global tensor (or array) ``x`` that the rank at
    ``coord`` (axis name -> index; default ``mesh.coord``) holds under
    ``spec``: each dim sharded over axes (a, b, ...) is cut into
    size(a) * size(b) * ... equal blocks, the first axis major, as JAX
    lays them out."""
    coord = mesh.coord if coord is None else coord
    idx = []
    for dim, ax in enumerate(tuple(spec) + (None,) * (x.ndim - len(spec))):
        if ax is None:
            idx.append(slice(None))
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        n, i = 1, 0
        for a in axes:
            n *= axis_size(mesh, a)
            i = i * axis_size(mesh, a) + (coord[a] if a in mesh.axis_names
                                          else 0)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not "
                             f"split over {axes} ({n} blocks)")
        step = x.shape[dim] // n
        idx.append(slice(i * step, (i + 1) * step))
    return x[tuple(idx)]


def shardings_in_order(like, shardings) -> list:
    """The (mesh, spec) pairs of ``shardings``, a tree of ``like``'s
    structure, in ``like``'s leaf order (a pair is a tuple, and a spec
    one too, so they are read by ``like``'s structure, not flattened)."""
    if isinstance(like, dict):
        return [p for k in sorted(like)
                for p in shardings_in_order(like[k], shardings[k])]
    if isinstance(like, (list, tuple)):
        return [p for v, s in zip(like, shardings, strict=True)
                for p in shardings_in_order(v, s)]
    return [] if like is None else [shardings]


def local_shards(tree, shardings, coord: dict | None = None):
    """:func:`local_shard` leaf by leaf over a tree of (mesh, spec)
    pairs of ``tree``'s structure."""
    return T.unflatten(tree, [
        local_shard(x, spec, mesh, coord) for x, (mesh, spec) in
        zip(T.leaves(tree), shardings_in_order(tree, shardings))])


def _blocks(spec, mesh, ndim: int) -> list[int]:
    """The number of blocks each of ``ndim`` dims is cut into."""
    out = []
    for ax in tuple(spec) + (None,) * (ndim - len(spec)):
        axes = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
        out.append(math.prod(axis_size(mesh, a) for a in axes))
    return out


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of one rank's block of a global ``shape`` under
    ``spec`` (JAX's ``sharding.shard_shape``)."""
    shape = tuple(shape)
    return tuple(d // n for d, n in zip(shape,
                                        _blocks(spec, mesh, len(shape))))


def global_shape(leaf, spec, mesh) -> tuple:
    """The global shape of the tensor whose block ``leaf`` (or a shape)
    is under ``spec``: the inverse of :func:`local_shape`."""
    shape = tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)
    return tuple(d * n for d, n in zip(shape,
                                       _blocks(spec, mesh, len(shape))))


def place(tree, specs, mesh, coord: dict | None = None):
    """The rank's blocks of ``tree``'s leaves under ``specs``, a tree of
    specs of ``tree``'s structure (``params_pspecs``): what one rank
    holds under the production placement."""
    return T.unflatten(tree, [
        local_shard(x, spec, mesh, coord) for x, spec in
        zip(T.leaves(tree), shardings_in_order(tree, specs))])
