"""Time the small-M logmac kernel at each K-split count on one CUDA card.

    python3 scripts/logmac_split_sweep.py

For the gemma2-2b projection shapes at P16 L-21b (M=4, and M=16, 32 on the
MLP shape) it runs the small-M kernel through ``kernels/logmac.py:
_launch_small`` with S = 1 .. 48 K-splits and prints the device time of
each (``chip_smoke.time_ms``: CUDA events, L2 flushed and the host run
ahead of the device, mean of 10), beside the split count that
``kernels/logmac.py:_plan`` picks.  This is the measurement behind the
plan's TARGET_BLOCKS.  Prints the card's name and power limit first.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

SHAPES = [(4, 2304, 9216), (4, 2304, 2304), (4, 2304, 1152), (4, 9216, 2304),
          (16, 2304, 9216), (32, 2304, 9216)]
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 36, 48)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("logmac_split_sweep: no CUDA device available", file=sys.stderr)
        return 2
    from chip_smoke import card_line, random_words, time_ms
    from repro_torch.core.engine import from_variant
    from repro_torch.kernels import logmac as LM

    print(card_line())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush_buf = torch.empty(64 * 2**20 // 4, device=dev)

    ecfg = from_variant(16, "L-21b")
    for M, K, N in SHAPES:
        a, b = (random_words(s, ecfg.posit, gen) for s in ((M, K), (K, N)))
        plan = LM._plan(M, N, K)
        out = torch.empty((M, N), device=dev)
        cells = []
        for want in SPLITS:
            ks = -(-K // (want * LM.K_ALIGN)) * LM.K_ALIGN
            at = plan._replace(splits=-(-K // ks), ks=ks)
            ms = time_ms(lambda: LM._launch_small(a, b, out, at, ecfg),
                         flush=flush_buf.zero_, device_only=True)
            cells.append(f"S={at.splits} ({at.blocks(N)} blocks) {ms:.4f}")
        print(f"P16 M={M} K={K} N={N}, plan S={plan.splits} "
              f"({plan.blocks(N)} blocks): " + ", ".join(cells) + " ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
