"""Training launcher of the port: data pipeline -> train step ->
checkpoint/failover loop.

  python -m repro_torch.launch.train --arch hymba-1.5b --steps 3 \\
      --batch 2 --seq 128 --log-every 1
  python -m repro_torch.launch.train --arch hymba-1.5b --smoke \\
      --device cpu --steps 3 --batch 2 --seq 32 --log-every 1

Counterpart of ``repro.launch.train`` with its flags and step log.  Trains
the FULL configuration unless ``--smoke`` is given, on ``--device cuda``
(the default; it raises when no CUDA device is present) or ``--device
cpu``.  ``--backend lax_ref`` (the default) is the differentiable path;
``cuda`` is forward-only and refuses at the first step.  Runs are
bit-identical on replay: float32 contractions at full precision
(``pin_exact_f32``) under :func:`deterministic`.

``--mesh single|multi`` trains data parallel on the production mesh
(``launch.mesh``: 16 x 16, or 2 x 16 x 16) over the launched world, one
process per rank, as ``torchrun`` starts them (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``; each rank on ``cuda:LOCAL_RANK``): the state replicated
from rank 0, each rank on its rows of the reference's global batch
(``batch_for_step(data, i, --batch, --seq)``), the gradients summed over
the data axes (``training.train_step``).  A world of another size raises.
Rank 0 logs and writes checkpoints.  ``--mesh local`` is one process.

Its numerics come from ``launch.build_numerics``, shared with
``launch.serve``.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch

from repro_torch import configs as C
from repro_torch import tree as T
from repro_torch.data import SyntheticLM, batch_for_step
from repro_torch.distributed import checkpoint as CK
from repro_torch.distributed import failover as F
from repro_torch.launch import build_numerics, pin_exact_f32
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.layers import Ctx
from repro_torch.models.transformer import Model
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.training import (broadcast_state, init_state,
                                  make_train_step, rank_rows, restore_state,
                                  save_state)


@contextlib.contextmanager
def deterministic():
    """Bit-identical replay on a CUDA card: cuBLAS's fixed workspace
    (``CUBLAS_WORKSPACE_CONFIG``, which must be set before the process's
    first cuBLAS call) and torch's deterministic algorithms (the
    embedding's backward as a sorted index_add, no float atomics).  The
    previous mode is restored on exit."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev)


def build(args, mesh=None):
    mod = C.get_config(args.arch)
    cfg = mod.SMOKE if args.smoke else mod.FULL
    nctx = build_numerics(args)
    model = Model(cfg, numerics=nctx, device=args.device)
    ctx = Ctx(numerics=nctx, mesh=mesh,
              moe_fsdp=cfg.family == "moe" and cfg.n_experts >= 64)
    opt = AdamW(lr=cosine_schedule(args.lr, args.warmup, args.steps),
                weight_decay=0.01)
    return model, cfg, ctx, opt


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="hymba-1.5b",
                    help="gemma2-2b, mamba2-1.3b or hymba-1.5b (the "
                         "reference's default, yi-6b, is not ported)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable); FULL without it")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--euler", default="L-21b",
                    help="variant name or 'exact'")
    ap.add_argument("--width", type=int, default=16)
    ap.add_argument("--policy", default="",
                    help="PrecisionPolicy JSON (inline or file path); "
                         "overrides --euler/--width for per-layer precision")
    ap.add_argument("--backend", default="lax_ref",
                    help="numerics backend (lax_ref is the differentiable "
                         "training path; cuda is forward-only)")
    ap.add_argument("--mesh", choices=["local", "single", "multi"],
                    default="local")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    return ap


def main(argv=None) -> dict:
    """Train; prints the reference's step log and returns a report with
    the final state, per-step losses and grad norms, seconds per step and
    the device's peak memory."""
    args = parser().parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available; "
                           "pass --device cpu to run on the CPU")
    mesh = None
    if args.mesh != "local":
        mesh = production_mesh(args)
    pin_exact_f32()
    with deterministic():
        return _train(args, mesh)


def production_mesh(args):
    """The production mesh over the launched world; on a card each rank
    computes on ``cuda:LOCAL_RANK`` (``args.device`` is set to it)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    want = 512 if args.mesh == "multi" else 256
    if world != want:
        raise SystemExit(
            f"--mesh {args.mesh} is the {'2x16x16' if want == 512 else '16x16'}"
            f" production mesh: launch {want} ranks (torchrun sets RANK, "
            f"WORLD_SIZE, LOCAL_RANK); this world has {world}")
    cpu = args.device == "cpu"
    if not cpu:
        args.device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    return make_production_mesh(multi_pod=args.mesh == "multi",
                                device="cpu" if cpu else "cuda")


def _train(args, mesh=None) -> dict:
    model, cfg, ctx, opt = build(args, mesh)
    lead = not torch.distributed.is_initialized() or \
        torch.distributed.get_rank() == 0
    dev = model.device
    held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    data = SyntheticLM(vocab=cfg.vocab, seed=args.seed)
    state = broadcast_state(init_state(model, opt, args.seed,
                                       compress=args.compress_grads))
    start = 0
    if (args.resume and args.ckpt_dir
            and CK.latest_step(args.ckpt_dir) is not None):
        state, start = restore_state(args.ckpt_dir, state, cfg)
        print(f"resumed from step {start}")
    step_fn = make_train_step(model, opt, ctx, grad_accum=args.grad_accum,
                              compress_grads=args.compress_grads)

    # single-host failover bookkeeping (a multi-host driver feeds beats
    # from every worker; here the API runs end to end)
    host = "host0"
    mon = F.HeartbeatMonitor([host], dead_after_s=600)
    det = F.StragglerDetector()
    pol = F.FailoverPolicy()

    emb_dim = cfg.d_model if cfg.embedding_inputs else None
    losses, gnorms = [], []
    t0 = time.time()
    for i in range(start, args.steps):
        batch = rank_rows(batch_for_step(data, i, args.batch, args.seq,
                                         embeddings_dim=emb_dim, device=dev),
                          ctx)
        state, out = step_fn(state, batch)
        losses.append(float(out["loss"]))
        gnorms.append(float(out["grad_norm"]))
        mon.beat(host, i)
        decision = pol.decide(mon, det, i)
        if decision.action != F.Action.CONTINUE:
            print(f"[failover] {decision.action}: {decision.reason}")
        if lead and args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_state(args.ckpt_dir, i + 1, state)
        if lead and (i % args.log_every == 0 or i == args.steps - 1):
            print(f"step {i:5d} loss {losses[-1]:.4f} "
                  f"gnorm {gnorms[-1]:.3f} "
                  f"lr {float(out['lr']):.2e} "
                  f"({(time.time() - t0) / max(i - start + 1, 1):.2f}s/step)")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.time() - t0
    if lead and args.ckpt_dir:
        save_state(args.ckpt_dir, args.steps, state)
    if lead:
        print("done")
    return {"state": state, "arch": cfg.name,
            "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "params": sum(p.numel() for p in T.leaves(state.params)),
            "losses": losses, "grad_norms": gnorms, "seconds": seconds,
            "s_per_step": seconds / max(args.steps - start, 1),
            "allocated_before": held,
            "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                     if dev.type == "cuda" else None)}


if __name__ == "__main__":
    main()
