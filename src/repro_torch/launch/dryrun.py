"""Multi-pod dry run: one rank of the production mesh runs every (arch x
shape x mesh) cell on shape-only tensors.

Counterpart of ``repro.launch.dryrun``.  The reference proves its
distribution config coherent without hardware by lowering and compiling
each cell with ``in_shardings`` on 256 or 512 host devices.  The port has
no SPMD compiler: the placement is explicit code (``Ctx(placement=
"production")``: tensor-parallel projections, the vocab-parallel
embedding and loss, head- or sequence-sharded caches, ZeRO-1 moments,
ZeRO-3 experts under ``moe_fsdp``).  So the port's dry run executes that
code as rank 0 of a 16 x 16 or 2 x 16 x 16 world of the ``fake`` process
group (``torch.testing._internal.distributed.fake_pg``: collectives
return at once), on ``meta`` tensors (shapes and dtypes, no storage), on
the ``lax_ref`` engine.  ``meta`` rather than ``FakeTensorMode``: the
same step of two gemma2-2b layers took 75 s under ``FakeTensorMode`` and
4.6 s on ``meta`` tensors (this repo's CPU); and an operand's plane
construction (about 500 aten ops a dot) runs once per shape and is
replayed after (``engine.shapes_only_planes``, outside autograd), which
makes a 32k prefill's 1024 chunk pairs a layer affordable.  No kernel
launches: the CUDA kernels do not pass through shape-only tensors, as the
JAX dry run runs nothing.  Each cell's record keeps the reference's keys:

  * ``memory``: ``argument_bytes``, the rank's placed parameters,
    optimizer moments, batch and caches; ``per_device_total``, the peak
    of the live bytes of the storages the step's ops produce, its
    arguments included (:class:`LiveBytes`); ``hbm_capacity``, the
    card's memory, or with no card ``mesh.H100_80GB_HBM3_BYTES``;
  * ``analytic``: ``analysis.costmodel``'s counts of the aten ops the
    rank dispatches (one rank's; ``*_global`` are them times the mesh
    size, and ``flops_per_device`` is the rank's), work every model rank
    repeats (a gathered attention) counted on each;
  * ``collectives``: every collective the rank issues, counted where
    ``distributed.collectives`` issues it, under the reference's HLO
    names, with the result's bytes on the rank.  The reference's
    ``parse_collectives`` reads XLA's optimized HLO and multiplies a loop
    body's collectives by its trip count; here a Python loop issues them
    once per trip, so ``bytes_effective`` equals ``bytes``.

XLA's ``cost_analysis`` and the lower and compile times have no
counterpart; the record says so under ``note``.

Usage (no card needed; on one CPU thread a decode cell takes 6-15 s, a
prefill_32k cell 13-31 min, a train_4k cell 14-113 min):
  python -m repro_torch.launch.dryrun --arch gemma2-2b \
      --shape decode_32k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh single --jobs 6 --out DIR
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs as C
from repro_torch import tree as T
from repro_torch.analysis import costmodel
from repro_torch.configs import euler_nce
from repro_torch.core import engine as _E
from repro_torch.distributed import collectives as COLL
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import hbm_capacity, make_mesh
from repro_torch.models.layers import Ctx
from repro_torch.models.transformer import Model, torch_dtype
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.training import TrainState, Zero1, make_train_step

NOTE = ("no counterpart of XLA's cost_analysis or of the lower/compile "
        "times: the port's placement is executed on fake tensors by one "
        "rank of a fake process group, not compiled")


def fake_world(n_devices: int, rank: int = 0) -> None:
    """This process as ``rank`` of an ``n_devices`` world of the fake
    process group (any earlier group is destroyed first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if (dist.get_backend() == "fake"
                and dist.get_world_size() == n_devices):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n_devices)


def _active_param_counts(params, cfg):
    """(total, active) parameter counts; MoE experts scaled by top_k/E.
    ``params``: the port's tree (per-layer lists), of any device."""
    total = active = 0
    for path, leaf in T.leaves_with_path(params):
        names = [str(k) for k in path]
        n = math.prod(leaf.shape)
        total += n
        if "moe" in names and "router" not in names and "dense" not in names:
            active += n * cfg.top_k / max(cfg.n_experts, 1)
        else:
            active += n
    return total, int(active)


def _nbytes(tree) -> int:
    return int(sum(math.prod(x.shape) * x.element_size()
                   for x in T.leaves(tree)))


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


@dataclasses.dataclass
class Cell:
    """One rank's step of a cell: ``fn(*args)``, ``args`` trees of
    ``meta`` tensors of the rank's shapes (made fake by :func:`run_cell`),
    ``parts`` the argument trees by kind (params, opt, batch, cache) and
    the reference's ``meta`` record."""
    fn: object
    args: tuple
    parts: dict
    meta: dict


def build_cell(arch: str, shape: str, mesh, *, ecfg=None, cfg_override=None,
               fsdp_experts=None, ctx_overrides=None, model_kwargs=None,
               grad_accum=None, shape_spec=None) -> Cell:
    """Construct one rank's step and its arguments for one cell.
    ``shape_spec``: a ``configs.SHAPES``-style entry in place of
    ``shape``'s (a cut-down cell)."""
    mod = C.get_config(arch)
    cfg = cfg_override or mod.FULL
    spec = shape_spec or C.SHAPES[shape]
    kind = spec["kind"]
    B, Tn = spec["global_batch"], spec["seq_len"]
    ecfg = ecfg or euler_nce.for_arch(cfg.dtype)
    model = Model(cfg, ecfg, device="cpu", **(model_kwargs or {}))

    fsdp = fsdp_experts
    if fsdp is None:
        fsdp = cfg.family == "moe" and cfg.n_experts >= 64  # arctic: ZeRO-3
    ctx = Ctx(ecfg=ecfg, numerics=model.numerics, mesh=mesh, moe_fsdp=fsdp,
              placement="production",
              **(ctx_overrides or {}))
    p_abs = model.init_shapes()
    params = SH.place(p_abs, SH.params_pspecs(p_abs, mesh,
                                              fsdp_experts=fsdp), mesh)
    cdt = torch_dtype(cfg.dtype)

    def batch_of(tree):
        """The rank's rows of a global batch of meta leaves."""
        return T.map(lambda x: _meta(SH.local_shape(
            x.shape, SH.batch_spec(mesh, x.ndim - 1, x.shape[0]), mesh),
            x.dtype), tree)

    def tok_spec(b, t):
        if cfg.embedding_inputs:
            return _meta((b, t, cfg.d_model), cdt)
        return _meta((b, t), torch.int64)

    total, active = _active_param_counts(p_abs, cfg)
    trips = {"layers": cfg.n_layers}
    if kind == "train":
        trips["loss_chunks"] = Tn // min(cfg.loss_chunk, Tn)
    if kind in ("train", "prefill") and cfg.family != "ssm":
        trips["attn_kv"] = Tn // min(cfg.kv_chunk, Tn)
    if kind in ("train", "prefill") and cfg.family in ("ssm", "hybrid"):
        trips["ssd_chunks"] = Tn // min(cfg.ssm_chunk, Tn)
    meta = {"arch": arch, "shape": shape, "kind": kind, "batch": B, "seq": Tn,
            "params_total": total, "params_active": active,
            "fsdp_experts": fsdp, "euler_variant": ecfg.variant,
            "scope_trips": trips, "mesh": dict(mesh.shape)}

    if kind == "train":
        # bf16 moments for the biggest MoE (arctic)
        sdt = torch.bfloat16 if total > 1e11 else torch.float32
        opt = AdamW(lr=cosine_schedule(3e-4, 2000, 100_000), state_dtype=sdt)
        zero = Zero1(model, mesh, fsdp)
        moments = [_meta(s, sdt) for s in zero.opt_shapes(params)]
        opt_state = {"m": T.unflatten(params, moments),
                     "v": T.unflatten(params, [_meta(m.shape, sdt)
                                               for m in moments]),
                     "count": _meta((), torch.int32)}
        state = TrainState(params=params, opt=opt_state,
                           step=_meta((), torch.int32))
        batch = batch_of({"inputs": tok_spec(B, Tn),
                          "labels": _meta((B, Tn), torch.int64)})
        # microbatch the 100B+ models: same global batch, 8 sequential
        # micro-steps
        ga = grad_accum if grad_accum else (8 if total > 1e11 else 1)
        meta["grad_accum"] = ga
        if ga > 1:
            trips["grad_accum"] = ga
        step_fn = make_train_step(model, opt, ctx, grad_accum=ga)
        meta["model_flops"] = 6.0 * active * B * Tn
        return Cell(lambda st, b: step_fn(st, b), (state, batch),
                    {"params": params, "opt": opt_state, "batch": batch},
                    meta)

    meta["cache_bytes"] = _nbytes(model.init_cache(B, Tn, device="meta"))
    cache = model.init_cache(B, Tn, device="meta", mesh=mesh)
    if kind == "prefill":
        toks = batch_of({"t": tok_spec(B, Tn)})["t"]
        meta["model_flops"] = 2.0 * active * B * Tn
        return Cell(lambda p, t, c: model.prefill(p, t, ctx, c),
                    (params, toks, cache),
                    {"params": params, "batch": toks, "cache": cache}, meta)
    if kind == "decode":
        tok = batch_of({"t": _meta((B,), torch.int64)})["t"]
        pos = _meta((), torch.int32)
        meta["model_flops"] = 2.0 * active * B
        return Cell(lambda p, t, q, c: model.decode_step(p, t, q, c, ctx),
                    (params, tok, pos, cache),
                    {"params": params, "batch": tok, "cache": cache}, meta)
    raise ValueError(kind)


class _RankCostMode(costmodel.CostMode):
    """The cost model's counts of this rank's ops, each counted once (the
    expert block's ``on_every_rank`` mark scales nothing here: the record
    multiplies every count by the mesh size)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        costmodel._count(self.counts, func, args, out)
        return out


class LiveBytes(TorchDispatchMode):
    """Live bytes of the storages the ops dispatched inside produce, and
    their peak: each storage counts from the op that makes it until it is
    freed (views and in-place ops add nothing).  ``track`` adds tensors
    made outside (the step's arguments)."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._seen: set = set()

    def track(self, *tensors) -> None:
        for t in tensors:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)

    def _free(self, key, n) -> None:
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.track(*(out if isinstance(out, (tuple, list)) else (out,)))
        return out


class _PlanesMemo:
    """``engine.shapes_only_planes``' memo: an operand's planes are built
    once per (shape, dtype, config); later calls get empty planes of the
    same shapes, the first call's counts added to the cost mode and its
    peak above the live bytes it started from added to the tracker."""

    def __init__(self, live: LiveBytes, cost: "_RankCostMode"):
        self.live, self.cost, self.seen = live, cost, {}

    def __call__(self, key, fn):
        hit = self.seen.get(key)
        if hit is None:
            counts0, live0, peak0 = (dict(self.cost.counts), self.live.live,
                                     self.live.peak)
            self.live.peak = live0
            out = fn()
            extra = self.live.peak - live0
            self.live.peak = max(peak0, self.live.peak)
            self.seen[key] = (
                [None if t is None else (tuple(t.shape), t.dtype)
                 for t in out],
                {k: self.cost.counts[k] - v for k, v in counts0.items()},
                extra)
            return out
        shapes, counts, extra = hit
        self.live.peak = max(self.live.peak, self.live.live + extra)
        for k, v in counts.items():
            self.cost.counts[k] += v
        return tuple(None if s is None else
                     torch.empty(s[0], dtype=s[1], device="meta")
                     for s in shapes)


def _own(tree, grad: bool = False):
    """Fresh ``meta`` tensors of the tree's shapes (not views of the
    global tensors the placement cut them from)."""
    def one(x):
        t = torch.empty(tuple(x.shape), dtype=x.dtype, device="meta")
        return t.requires_grad_(True) if grad else t
    if isinstance(tree, TrainState):
        return TrainState(params=_own(tree.params, True),
                          opt=_own(tree.opt), step=_own(tree.step))
    return T.map(one, tree)


def run_cell(arch: str, shape: str, multi_pod: bool, *, ecfg=None,
             cfg_override=None, fsdp_experts=None, ctx_overrides=None,
             model_kwargs=None, grad_accum=None, mesh_shape=None,
             shape_spec=None) -> dict:
    """Run one rank's step of a cell on meta tensors; return the record.
    ``mesh_shape``: (data, model) or (pod, data, model) sizes in place of
    the production mesh's (a cut-down cell, with ``shape_spec``)."""
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    mesh_shape = tuple(mesh_shape)
    multi_pod = len(mesh_shape) == 3
    n_dev = math.prod(mesh_shape)
    fake_world(n_dev)
    mesh = make_mesh(mesh_shape, ("pod", "data", "model")[-len(mesh_shape):],
                     device="cpu")
    t0 = time.time()
    cell = build_cell(arch, shape, mesh, ecfg=ecfg,
                      cfg_override=cfg_override, fsdp_experts=fsdp_experts,
                      ctx_overrides=ctx_overrides, model_kwargs=model_kwargs,
                      grad_accum=grad_accum, shape_spec=shape_spec)
    rec = dict(cell.meta)
    rec.update({"multi_pod": multi_pod, "n_devices": n_dev, "ok": False,
                "note": NOTE})
    try:
        arg_bytes = _nbytes(list(cell.parts.values()))
        args = tuple(_own(a) for a in cell.args)
        live = LiveBytes()
        for a in args:
            live.track(*T.leaves(a.tree() if isinstance(a, TrainState)
                                 else a))
        cost = _RankCostMode()
        with live, COLL.recording() as colls, cost, \
                _E.shapes_only_planes(_PlanesMemo(live, cost)):
            cell.fn(*args)
        an = cost.counts
        rec.update({
            "ok": True,
            "run_s": round(time.time() - t0, 2),
            "memory": {
                "argument_bytes": arg_bytes,
                "per_device_total": int(live.peak),
                "hbm_capacity": hbm_capacity(),
            },
            "analytic": {
                "dot_flops_global": an["dot_flops"] * n_dev,
                "ew_flops_global": an["ew_flops"] * n_dev,
                "dot_traffic_global": an["dot_traffic"] * n_dev,
                "flops_per_device": an["dot_flops"] + an["ew_flops"],
                "dot_traffic_per_device": an["dot_traffic"],
            },
            "collectives": colls,
        })
        rec["fits_hbm"] = bool(rec["memory"]["per_device_total"]
                               <= rec["memory"]["hbm_capacity"])
    except Exception as e:  # noqa: BLE001 — record the failure verbatim
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
    return rec


def _print_summary(rec):
    m = rec.get("memory", {})
    a = rec.get("analytic", {})
    coll_b = sum(v.get("bytes_effective", v.get("bytes", 0))
                 for v in rec.get("collectives", {}).values())
    status = "OK " if rec.get("ok") else "FAIL"
    print(f"[{status}] {rec['arch']:24s} {rec['shape']:12s} "
          f"mesh={'x'.join(map(str, rec['mesh'].values())):8s} "
          f"mem/dev={m.get('per_device_total', 0)/2**30:7.2f}GiB "
          f"fits={rec.get('fits_hbm', '-')} "
          f"gflops/dev={a.get('flops_per_device', 0)/1e9:10.1f} "
          f"coll/dev={coll_b/2**20:9.1f}MiB "
          f"run={rec.get('run_s', 0):6.1f}s", flush=True)
    if not rec.get("ok"):
        print("      ", rec.get("error", "?")[:500], flush=True)


def _write(rec, out: str) -> None:
    fn = (f"{out}/{rec['arch']}__{rec['shape']}__"
          f"{'multi' if rec['multi_pod'] else 'single'}.json")
    with open(fn, "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--jobs", type=int, default=1,
                    help="parallel worker processes for --all")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    torch.set_num_threads(1)

    if args.all:
        cells = [(a, s, mp) for a, s, app in C.all_cells() if app
                 for mp in meshes]
        if args.jobs > 1:
            # the longest cells first: train, then prefill, then decode
            order = {"train": 0, "prefill": 1, "decode": 2}
            pending = sorted(
                cells, key=lambda c: order[C.SHAPES[c[1]]["kind"]])
            procs, rc = [], 0
            while pending or procs:
                while pending and len(procs) < args.jobs:
                    a, s, mp = pending.pop(0)
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", a, "--shape", s,
                           "--mesh", "multi" if mp else "single",
                           "--out", args.out]
                    procs.append(((a, s, mp), subprocess.Popen(cmd)))
                done = [(k, p) for k, p in procs if p.poll() is not None]
                procs = [(k, p) for k, p in procs if p.poll() is None]
                for (a, s, mp), p in done:
                    if p.returncode != 0:
                        rc = 1
                        print(f"[worker FAIL rc={p.returncode}] {a} {s} "
                              f"mp={mp}", flush=True)
                time.sleep(1.0)
            sys.exit(rc)
        rc = 0
        for a, s, mp in cells:
            rec = run_cell(a, s, mp)
            _print_summary(rec)
            _write(rec, args.out)
            rc |= 0 if rec["ok"] else 1
        sys.exit(rc)

    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    rc = 0
    for mp in meshes:
        rec = run_cell(args.arch, args.shape, mp)
        _print_summary(rec)
        _write(rec, args.out)
        rc |= 0 if rec["ok"] else 1
    sys.exit(rc)


if __name__ == "__main__":
    main()
