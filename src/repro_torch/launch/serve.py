"""Serving launcher of the port: init a model from a seed and drain batched
requests through the continuous-batching scheduler.

  python -m repro_torch.launch.serve --arch gemma2-2b --full --paged \\
      --cache-dtype uint16 --backend cuda

Runs on ``--device cuda`` (the default) and raises when no CUDA device is
present; ``--device cpu`` runs the kernels' plain versions on the CPU
(tests use it with the SMOKE config).
"""
from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from repro_torch import configs as C
from repro_torch.core.engine import from_variant
from repro_torch.models.layers import Ctx
from repro_torch.models.transformer import Model
from repro_torch.numerics import NumericsContext, PrecisionPolicy
from repro_torch.serving import (GenerationConfig, PagedKVConfig,
                                 RequestBatcher, ServeEngine)


def build_numerics(args) -> NumericsContext:
    policy = PrecisionPolicy.uniform(from_variant(args.width, args.euler))
    return NumericsContext(policy=policy, backend=args.backend)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--full", action="store_true",
                    help="serve the FULL configuration (default: SMOKE)")
    ap.add_argument("--euler", default="L-21b",
                    help="paper variant, L-1 .. L-22b (the exact backend "
                         "ignores it)")
    ap.add_argument("--width", type=int, default=16)
    ap.add_argument("--backend", default="lax_ref",
                    choices=("exact", "lax_ref", "cuda"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
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
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> dict:
    """Serve once; prints a summary and returns it as a dict."""
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available; "
                           "pass --device cpu to run on the CPU")
    mod = C.get_config(args.arch)
    cfg = mod.FULL if args.full else mod.SMOKE
    nctx = build_numerics(args)
    model = Model(cfg, numerics=nctx, device=args.device)
    dev = model.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(args.seed)
    paged = (PagedKVConfig(page_size=args.page_size,
                           num_pages=args.num_pages or None)
             if args.paged else None)
    eng = ServeEngine(model, params, Ctx(numerics=nctx),
                      max_len=args.max_len, batch=args.batch,
                      cache_dtype=args.cache_dtype or None, paged=paged)
    batcher = RequestBatcher(eng, prompt_buckets=(32, 128))
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        plen = int(rng.integers(4, 24))
        batcher.submit(rng.integers(0, cfg.vocab, plen), max_new=args.max_new)

    done_at: dict[int, float] = {}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    results = batcher.run(
        GenerationConfig(max_new_tokens=args.max_new),
        on_complete=lambda rid, toks: done_at.setdefault(
            rid, time.perf_counter()))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
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
        "preempts": s["preempts"],
        "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else None),
        "results": results, "engine": eng, "batcher": batcher,
    }
    print(f"served {len(results)} requests, {ntok} tokens in {dt:.2f}s "
          f"({report['tok_per_s']:.1f} tok/s) on {dev} with {args.backend} "
          f"under {nctx.policy.default.variant}@posit"
          f"{nctx.policy.default.width} [{s['steps']} steps, {s['refills']} "
          f"mid-stream refills]")
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
