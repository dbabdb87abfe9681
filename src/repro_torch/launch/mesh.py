"""Device meshes over ``torch.distributed``.

Counterpart of ``repro.launch.mesh``: ``make_production_mesh`` (16 x 16
single pod, 2 x 16 x 16 multi-pod) and ``make_mesh`` for any shape, both
over ``torch.distributed.device_mesh.init_device_mesh`` with the axis
names as ``mesh_dim_names``.  One process is one rank of the mesh; the
launched world must hold exactly as many ranks as the mesh has places
(the reference raises the same way without that many devices).

The process group comes from the launcher's environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``, as ``torchrun`` sets
them) unless the caller initialised one already.  The mesh lives on the
card (NCCL) unless the caller asks for the CPU (``device="cpu"``, gloo)
or names another ``backend``: gloo on ``cuda`` runs several ranks on one
card, which NCCL refuses.

:class:`Mesh` is what the sharding rules, ``models.layers.Ctx`` and the
data-parallel step read: ``shape`` (axis name -> size, as JAX's
``Mesh.shape``), ``axis_names``, this rank's ``coord`` and the process
group of one axis or of several together (``group(("pod", "data"))``,
``group(("data", "model"))``: every set of axes of more than one rank
has its group, made when the mesh is).

``HW`` holds one card's figures under the reference's keys, each a data
sheet value of the NVIDIA H100 80GB HBM3 (SXM, 700 W): dense bf16 989
TFLOP/s, HBM3 3.35 TB/s, NVLink 4 in place of the TPU's ICI and one
InfiniBand NDR port (400 Gb/s) per GPU in place of DCN.  ``hbm_bytes`` is
the card's memory as ``torch.cuda.get_device_properties`` reports it, read
on first use (it raises where there is no card); :func:`hbm_capacity`
falls back to the H100's figure, :data:`H100_80GB_HBM3_BYTES`, where
there is none (the dry run on fake ranks).
"""
from __future__ import annotations

import itertools
import math
import os

import torch
import torch.distributed as dist


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda",
                         backend: str | None = None) -> "Mesh":
    """16x16 single pod (256 ranks) or 2x16x16 multi-pod (512 ranks).

    ``pod`` is data parallel across the slow links, ``data`` is in-pod
    data parallel, ``model`` the tensor/expert-parallel axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device, backend=backend)


def make_mesh(shape, axes, *, device: str = "cuda",
              backend: str | None = None) -> "Mesh":
    """A mesh of ``shape`` named ``axes`` over the launched world."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    if not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if device == "cuda" else "gloo"))
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(
            f"a {'x'.join(map(str, shape))} mesh {axes} needs "
            f"{math.prod(shape)} ranks; the launched world has {world}")
    if device == "cuda" and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    from torch.distributed.device_mesh import init_device_mesh
    return Mesh(init_device_mesh(device, shape, mesh_dim_names=axes))


class Mesh:
    """A ``DeviceMesh`` seen as the reference's rules see a JAX mesh."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.shape))
        self.coord = dict(zip(self.axis_names, device_mesh.get_coordinate()))
        self._groups = {(a,): device_mesh.get_group(a)
                        for a in self.axis_names if self.shape[a] > 1}
        # every set of two or more axes together (the data axes; data and
        # model, the group of an activation split over both): every rank
        # creates every slice's group, in the same order, and keeps its own
        wide = [a for a in self.axis_names if self.shape[a] > 1]
        for n in range(2, len(wide) + 1):
            for axes in itertools.combinations(wide, n):
                self._groups[axes] = self._joint_group(axes)

    def _joint_group(self, axes):
        ranks = self.device_mesh.mesh           # [*shape] global ranks
        dims = [self.axis_names.index(a) for a in axes]
        rest = [d for d in range(ranks.ndim) if d not in dims]
        mine = None
        for fixed in itertools.product(*(range(ranks.shape[d])
                                          for d in rest)):
            idx = [slice(None)] * ranks.ndim
            for d, i in zip(rest, fixed):
                idx[d] = i
            members = ranks[tuple(idx)].permute(
                *[sorted(dims).index(d) for d in dims]).reshape(-1).tolist()
            g = dist.new_group(members)
            if dist.get_rank() in members:
                mine = g
        return mine

    def size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape[a] for a in axes if a in self.shape)

    def group(self, axes):
        """The process group of ``axes`` (one name or a tuple, in mesh
        order), or None where they span one rank."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        axes = tuple(a for a in self.axis_names
                     if a in axes and self.shape[a] > 1)
        if not axes:
            return None
        return self._groups[axes]

    def index(self, axes) -> int:
        """This rank's position along ``axes`` taken together, the first
        axis major (how JAX lays a tuple of axes over one dimension)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        i = 0
        for a in axes:
            if a in self.axis_names:
                i = i * self.shape[a] + self.coord[a]
        return i


# ``torch.cuda.get_device_properties(0).total_memory`` of the NVIDIA H100
# 80GB HBM3 as the card reports it (chip_smoke's 3l(e) prints it); the dry
# run's ``hbm_capacity`` where no card is present
H100_80GB_HBM3_BYTES = 85_017_493_504


def hbm_capacity() -> int:
    """One card's memory: read from the card where there is one, else the
    H100's stated figure (:data:`H100_80GB_HBM3_BYTES`)."""
    if torch.cuda.is_available():
        return HW["hbm_bytes"]
    return H100_80GB_HBM3_BYTES


class _HW(dict):
    """The card's figures; ``hbm_bytes`` is read from the card on first
    use."""

    def __missing__(self, key):
        if key != "hbm_bytes":
            raise KeyError(key)
        if not torch.cuda.is_available():
            raise RuntimeError("HW['hbm_bytes'] is the card's memory; no "
                               "CUDA device is available")
        self[key] = torch.cuda.get_device_properties(0).total_memory
        return self[key]


# NVIDIA H100 80GB HBM3 SXM data sheet values at 700 W
HW = _HW({
    "peak_bf16_flops": 989e12,   # FLOP/s per GPU, dense bf16
    "hbm_bandwidth": 3.35e12,    # B/s per GPU, HBM3
    "ici_bandwidth": 450e9,      # B/s per GPU and direction, NVLink 4
                                 # (18 links, 900 GB/s both ways)
    "dcn_bandwidth": 50e9,       # B/s per GPU, InfiniBand NDR 400 Gb/s
})
