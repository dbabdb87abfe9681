"""A profiled serving drain of a FULL model for any checkout of the port,
so that two versions can be compared in one call.

    python3 scripts/profile_drain.py                    # this checkout
    python3 scripts/profile_drain.py --src DIR --tag parent
    python3 scripts/profile_drain.py --arch mamba2-1.3b  # or hymba-1.5b

``--src`` names the root of another checkout (its ``src/repro_torch`` is
imported and its kernels are built under its own ``build/``).  Serves
``--arch`` FULL unguarded through that checkout's launcher as chip_smoke's
phases 3 and 3f do (seed 0, batch 4, P16 L-21b on the ``cuda`` backend;
gemma2-2b with a paged uint16 cache, mamba2-1.3b and hymba-1.5b with a
dense one; 4 requests x 4 tokens to warm up), then traces a drain
of 2 requests x 4 tokens with ``chip_smoke.profile_drain`` from this
checkout: kernel time and wall window, the port's kernels by name, torch's
kernels and among them the kinds the pow2 pre-scale runs, the top 20.
"""
from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# chip_smoke.py's helpers, from this checkout; imported before --src goes
# first on the path (chip_smoke puts this checkout's src there)
sys.path.insert(0, os.path.join(HERE, ".."))
from chip_smoke import card_line, log, profile_drain  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(HERE, ".."),
                    help="root of the checkout whose port is profiled")
    ap.add_argument("--tag", default="this checkout")
    ap.add_argument("--arch", default="gemma2-2b",
                    choices=("gemma2-2b", "mamba2-1.3b", "hymba-1.5b"))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.abspath(args.src), "src"))
    import torch
    if not torch.cuda.is_available():
        print("profile_drain: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.launch import serve

    card = card_line()
    log(f"{card}; {args.tag}: repro_torch from "
        f"{os.path.dirname(_build.__file__)}")
    _build.build_all()
    cache = (["--paged", "--page-size", "16", "--cache-dtype", "uint16"]
             if args.arch == "gemma2-2b" else [])
    rep = serve.main(["--arch", args.arch, "--full", *cache,
                      "--backend", "cuda", "--euler", "L-21b", "--width",
                      "16", "--device", "cuda", "--batch", "4", "--max-len",
                      "256", "--requests", "4", "--max-new", "4",
                      "--seed", "0"])
    log(f"[{args.tag}] warm-up served {rep['tokens']} tokens, "
        f"{rep['tok_per_s']:.2f} tok/s, launches {rep['launches']}")
    profile_drain(rep["engine"], f"{card} ({args.tag}, {args.arch})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
