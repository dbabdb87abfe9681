"""Error of logmac's kernels against the float64 product, on one CUDA card.

    python3 scripts/logmac_error.py

For P16 L-21b (the fp16 tensor-core kernel), P16 L-1, P32 L-21b and P32
L-22b (the bf16-piece kernel) and P32 L-21 (the f32 tile kernel) at M=128,
N=2304 and K in {300, 2304, 9216}, on chip_smoke's spread words
(``random_words``) and on words of unit-scale values, it prints the largest
and the mean |result - exact| of the kernel the plan picks, of the plain
version (torch's f32 matmul of the planes) and of the f32 tile kernel run
on the same words, where exact is the float64 product of the planes; and
how many outputs miss the flat bar rtol 1e-5 / atol 1e-4 against the plain
version.  Prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

FORMATS = [(16, "L-21b"), (16, "L-1"), (32, "L-21b"), (32, "L-22b"),
           (32, "L-21")]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("logmac_error: no CUDA device available", file=sys.stderr)
        return 2
    from chip_smoke import card_line, random_words
    from repro_torch.core.engine import from_variant
    from repro_torch.kernels import _build
    from repro_torch.kernels import logmac as LM
    from repro_torch.kernels import posit_codec as PC

    print(card_line(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    fn = _build.function("logmac", "logmac_launch",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                         + [ctypes.c_void_p])

    def tile(a, b, cfg):
        out = torch.empty(a.shape[0], b.shape[1], device=dev)
        _build.check(fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                        a.shape[0], b.shape[1], a.shape[1],
                        *LM._format_args(cfg), _build.stream_ptr(a)),
                     "logmac tile")
        return out

    M, N = 128, 2304
    for width, variant in FORMATS:
        cfg = from_variant(width, variant)
        for K in (300, 2304, 9216):
            for data in ("spread", "unit"):
                if data == "spread":
                    a, b = (random_words(s, cfg.posit, gen)
                            for s in ((M, K), (K, N)))
                else:
                    a, b = (PC.posit_encode(torch.randn(
                        s, generator=gen, device=dev), cfg.posit)
                        for s in ((M, K), (K, N)))
                va, ra = LM.decode_planes(a, cfg)
                vb, rb = LM.decode_planes(b, cfg)
                exact = va.double() @ vb.double()
                if LM.subtracts_rem(cfg):
                    exact = exact - ra.double() @ rb.double()
                got = LM.logmac(a, b, cfg)
                plain = LM.logmac_plain(a, b, cfg)
                cells = []
                for name, out in (("kernel", got), ("plain", plain),
                                  ("tile", tile(a, b, cfg))):
                    d = (out.double() - exact).abs()
                    cells.append(f"{name} max {float(d.max()):.3g} mean "
                                 f"{float(d.mean()):.3g}")
                miss = int(((got - plain).abs()
                            > 1e-4 + 1e-5 * plain.abs()).sum())
                print(f"P{width} {variant} "
                      f"({LM.plan_of(M, N, K, cfg).kind}) M={M} K={K} "
                      f"N={N} {data}: max|exact| "
                      f"{float(exact.abs().max()):.4g}; " + "; ".join(cells)
                      + f"; flat-bar misses {miss} of {M * N}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
