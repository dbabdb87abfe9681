"""Serving launcher of the port: init a model from a seed and drain batched
requests through the continuous-batching scheduler.

  python -m repro_torch.launch.serve --arch gemma2-2b --full --paged \\
      --cache-dtype uint16 --backend cuda
  python -m repro_torch.launch.serve --arch mamba2-1.3b --full --backend cuda
  python -m repro_torch.launch.serve --arch llama4-scout-17b-a16e --full \
      --layers 4 --paged --cache-dtype uint16 --backend cuda

Runs on ``--device cuda`` (the default) and raises when no CUDA device is
present; ``--device cpu`` runs the kernels' plain versions on the CPU
(tests use it with the SMOKE config).  Float32 contractions run at full
precision (``pin_exact_f32``: no TF32).  ``--arch`` takes the ten ids of
``repro_torch.configs.ALIASES``; ``--layers`` cuts the chosen config's
depth (full width, seeded random weights).  mamba2-1.3b and hymba-1.5b
hold recurrent SSM state and serve from a dense cache only (``--paged``
raises).  The audio (musicgen-large) and vlm (chameleon-34b) families are
served from token ids (musicgen's EnCodec codes), as the reference
launcher serves them; their stub frontend's float embeddings go through
``Model.prefill`` directly.

Numerics: ``--euler``/``--width`` give a uniform policy, ``--policy`` a
PrecisionPolicy JSON (inline or a file, the reference's schema) through
``launch.build_numerics``, which both launchers share.  ``--eos-id``
stops a request at that token; ``--stream`` prints each request as it
completes.

Weights and durability:

  --ckpt-dir         serve the params of a checkpoint the JAX package
                     wrote there (``{"params": ...}`` or a training
                     ``TrainState``; read with
                     ``distributed.checkpoint.restore_numpy``, converted
                     with ``params_from_jax``) instead of the seeded init
  --snapshot-dir     durable serving: snapshot the scheduler state there
                     every --snapshot-every decode steps
  --resume           restore the drain from --snapshot-dir instead of
                     submitting fresh requests
  --temperature      sample (0: greedy)

Fault-tolerant serving knobs:

  --guard            run the datapath through the ``guarded:<backend>`` ABFT
                     wrapper; unrecovered checksum violations re-enqueue the
                     hit request at higher precision (--guard-retry bound)
  --deadline-ms      per-request wall-clock SLO; expired requests retire
                     with status "timeout" instead of holding their slot
  --degrade-ladder   comma-separated posit widths BELOW --width (e.g. "8"
                     under --width 16 gives P16 -> P8); under queue pressure
                     new requests are admitted further down the ladder
                     (--slo-queue-hi queued requests per level)
"""
from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from repro_torch import configs as C
from repro_torch.distributed import checkpoint as CK
from repro_torch.kernels import _build
from repro_torch.launch import build_numerics, pin_exact_f32
from repro_torch.models.layers import Ctx
from repro_torch.models.transformer import Model, params_from_jax
from repro_torch.numerics import NumericsContext
from repro_torch.numerics import api as napi
from repro_torch.serving import (DurableBatcher, GenerationConfig,
                                 PagedKVConfig, QueueFullError,
                                 RequestBatcher, ServeEngine, SLOConfig)


def build_levels(args, primary: NumericsContext
                 ) -> list[NumericsContext] | None:
    """The precision ladder of ``--degrade-ladder`` below ``primary``
    (None without it)."""
    if not args.degrade_ladder:
        return None
    if args.euler == "exact":
        raise SystemExit("--degrade-ladder needs a posit format (--euler), "
                         "not exact")
    widths = [int(w) for w in args.degrade_ladder.split(",") if w]
    top = primary.policy.default.width
    if any(w >= top for w in widths):
        raise SystemExit(f"--degrade-ladder widths {widths} must sit "
                         f"strictly below the primary width {top}")
    return [primary] + [build_numerics(args, w, guard=args.guard)
                        for w in widths]


def load_jax_params(ckpt_dir: str, cfg, device):
    """The ``params`` subtree of a checkpoint the JAX package wrote (a
    ``{"params": ...}`` tree or a ``TrainState``), as this package's
    parameter dicts on ``device``."""
    tree = CK.nest(CK.restore_numpy(ckpt_dir)).get("params")
    if not tree:
        raise KeyError(f"no params leaves in the checkpoint at {ckpt_dir}")
    return params_from_jax(tree, cfg, device=device)


def _launch_counts():
    return (dict(_build.LAUNCHES),
            {k: dict(v) for k, v in _build.WIDTH_LAUNCHES.items()})


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--full", action="store_true",
                    help="serve the FULL configuration (default: SMOKE)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to this many layers (0: all)")
    ap.add_argument("--euler", default="L-21b",
                    help="paper variant, L-1 .. L-22b, or 'exact' (the "
                         "exact backend ignores it)")
    ap.add_argument("--width", type=int, default=16)
    ap.add_argument("--policy", default="",
                    help="PrecisionPolicy JSON (inline or file path); "
                         "overrides --euler/--width for per-layer precision")
    ap.add_argument("--backend", default="lax_ref",
                    choices=("exact", "lax_ref", "cuda"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="stop a request at this token id (-1: no EOS)")
    ap.add_argument("--stream", action="store_true",
                    help="print each request the step it completes")
    ap.add_argument("--ckpt-dir", default="",
                    help="serve the params of a checkpoint the JAX package "
                         "wrote here instead of the seeded init")
    ap.add_argument("--snapshot-dir", default="",
                    help="durable serving: snapshot the scheduler state here "
                         "at step boundaries (enables --resume)")
    ap.add_argument("--snapshot-every", type=int, default=8,
                    help="decode steps between scheduler snapshots")
    ap.add_argument("--resume", action="store_true",
                    help="restore the drain from --snapshot-dir instead of "
                         "submitting fresh requests")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: shared page pool + per-slot page "
                         "tables; decode runs the fused flash-decode kernel "
                         "on the cuda backend for integer pages")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=0,
                    help="physical pages in the pool (0: full occupancy "
                         "for every slot + headroom)")
    ap.add_argument("--cache-dtype", default="",
                    help="KV cache dtype: uint8|uint16|uint32 posit words "
                         "or float32|bfloat16 (default: the config's)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="admission cap: submit() fails beyond this many "
                         "queued requests (0: unbounded)")
    ap.add_argument("--guard", action="store_true",
                    help="ABFT-guard the datapath (guarded:<backend>) and "
                         "re-enqueue requests hit by unrecovered violations")
    ap.add_argument("--guard-retry", type=int, default=2,
                    help="max guard-triggered re-enqueues per request before "
                         "it retires with status 'failed'")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request wall-clock deadline; 0 disables")
    ap.add_argument("--degrade-ladder", default="",
                    help="comma-separated posit widths below --width (e.g. "
                         "'8'); enables SLO-aware admission degradation")
    ap.add_argument("--slo-queue-hi", type=int, default=4,
                    help="queued requests per one-level admission demotion")
    ap.add_argument("--slo-p99-ms", type=float, default=0.0,
                    help="step-latency p99 threshold adding one more "
                         "demotion level; 0 disables")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> dict:
    """Serve once; prints a summary and returns it as a dict."""
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    if args.resume and not args.snapshot_dir:
        raise SystemExit("--resume requires --snapshot-dir")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available; "
                           "pass --device cpu to run on the CPU")
    pin_exact_f32()
    mod = C.get_config(args.arch)
    cfg = mod.FULL if args.full else mod.SMOKE
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    nctx = build_numerics(args, guard=args.guard)
    levels = build_levels(args, nctx)
    model = Model(cfg, remat=False, numerics=nctx, device=args.device)
    dev = model.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = None
    if args.ckpt_dir:
        try:
            params = load_jax_params(args.ckpt_dir, cfg, dev)
            print(f"loaded params from step {CK.latest_step(args.ckpt_dir)}")
        except (OSError, KeyError, ValueError) as e:
            print(f"no checkpoint loaded ({e}); serving random init")
    if params is None:
        params = model.init(args.seed)
    paged = (PagedKVConfig(page_size=args.page_size,
                           num_pages=args.num_pages or None)
             if args.paged else None)
    eng = ServeEngine(model, params, Ctx(numerics=nctx),
                      max_len=args.max_len, batch=args.batch,
                      cache_dtype=args.cache_dtype or None, levels=levels,
                      paged=paged)
    slo = (SLOConfig(queue_hi=args.slo_queue_hi,
                     p99_ms=args.slo_p99_ms or None) if levels else None)
    kw = dict(max_queue=args.max_queue or None, slo=slo,
              guard_retry=args.guard_retry if args.guard else 0)
    if args.snapshot_dir:
        batcher = DurableBatcher(eng, prompt_buckets=(32, 128),
                                 ckpt_dir=args.snapshot_dir,
                                 snapshot_every=args.snapshot_every, **kw)
    else:
        batcher = RequestBatcher(eng, prompt_buckets=(32, 128), **kw)
    rng = np.random.default_rng(args.seed)
    dropped = 0
    for _ in range(0 if args.resume else args.requests):
        plen = int(rng.integers(4, 24))
        try:
            batcher.submit(rng.integers(0, cfg.vocab, plen),
                           max_new=args.max_new,
                           deadline_ms=args.deadline_ms or None)
        except QueueFullError:  # admission control: shed, keep serving
            dropped += 1
    if dropped:
        print(f"queue full: dropped {dropped}/{args.requests} requests "
              f"(max_queue={args.max_queue})")

    done_at: dict[int, float] = {}
    napi.reset_guard_stats()
    launches0, by_width0 = _launch_counts()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()

    def on_complete(rid, toks):
        now = done_at.setdefault(rid, time.perf_counter())
        if args.stream:
            print(f"  [{now - t0:6.2f}s] req {rid} done ({len(toks)} "
                  f"tokens): {toks[:8]}...")

    if args.resume:
        results = batcher.resume(on_complete=on_complete)
    else:
        results = batcher.run(
            GenerationConfig(max_new_tokens=args.max_new,
                             temperature=args.temperature,
                             eos_id=None if args.eos_id < 0 else args.eos_id),
            on_complete=on_complete)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    launches1, by_width1 = _launch_counts()
    ntok = sum(len(v) for v in results.values())
    lat = np.asarray([done_at[r] - t0 for r in sorted(done_at)])
    s = batcher.stats
    report = {
        "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "backend": args.backend, "device": str(dev),
        "requests": len(results), "tokens": ntok, "seconds": dt,
        "tok_per_s": ntok / dt if dt > 0 else float("nan"),
        "latency_p50_s": float(np.percentile(lat, 50)) if len(lat) else None,
        "latency_p99_s": float(np.percentile(lat, 99)) if len(lat) else None,
        "steps": s["steps"], "refills": s["refills"],
        "rejected": s["rejected"], "kv_oom": s["kv_oom"],
        "preempts": s["preempts"], "dropped": dropped,
        "timeouts": s["timeouts"], "demotions": s["demotions"],
        "mixed_steps": s["mixed_steps"],
        "guard_retries": s["guard_retries"],
        "guard": napi.guard_totals(reset=True) if args.guard else None,
        "statuses": dict(batcher.statuses),
        "launches": {k: n - launches0[k] for k, n in launches1.items()},
        "launches_by_width": {
            k: {w: n - by_width0[k].get(w, 0) for w, n in v.items()}
            for k, v in by_width1.items()},
        "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else None),
        "snapshot_s": getattr(batcher, "snapshot_s", None),
        "snapshot_bytes": getattr(batcher, "snapshot_bytes", None),
        "results": results, "engine": eng, "batcher": batcher,
    }
    print(f"served {len(results)} requests, {ntok} tokens in {dt:.2f}s "
          f"({report['tok_per_s']:.1f} tok/s) on {dev} with {args.backend} "
          f"under {nctx.policy.default.variant}@posit"
          f"{nctx.policy.default.width} [{s['steps']} steps, {s['refills']} "
          f"mid-stream refills]")
    if s["timeouts"] or s["guard_retries"] or s["demotions"]:
        print(f"  SLO: {s['timeouts']} timeouts, {s['demotions']} admission "
              f"demotions ({s['mixed_steps']} mixed-level steps), "
              f"{s['guard_retries']} guard retries")
    if args.guard:
        t = report["guard"]
        print(f"  guard: {t['checks']} checks, {t['violations']} violations, "
              f"{t['recovered']} recovered, {t['unrecovered']} unrecovered")
    if args.paged:
        kv = eng.kv
        print(f"  paged: page_size={kv.page_size}, peak "
              f"{kv.peak_pages}/{kv.alloc.num_pages} pages, "
              f"{s['kv_oom']} OOM backpressures, {s['preempts']} preempts, "
              f"{s['rejected']} rejected")
    for rid in sorted(results)[:4]:
        print(f"  req {rid}: {results[rid][:8].tolist()}...")
    return report


if __name__ == "__main__":
    main()
