"""Times of the port's encode, logmac and paged-decode kernels, for any
checkout of the port, so that two versions can be compared in one call.

    python3 scripts/kernel_times.py                    # this checkout
    python3 scripts/kernel_times.py --src DIR --tag parent

``--src`` names the root of another checkout (its ``src/repro_torch`` is
imported and its kernels are built under its own ``build/``).  Times an
operand's pow2 pre-scale and encode at the five gemma2-2b weight shapes
(the model init's scale) and a decode activation [4, 2304]: the fused
``posit_encode_prescaled`` where the checkout has it, and the parent
route (torch's ``_pow2_scale``, the divide, ``posit_encode``) and the
plain ``posit_encode`` in every checkout, and, but for the head, the plain
encode's device time after a read of x (does the fused call's second read
of x reach HBM?); logmac at P16 L-21b, M=4, on
the five gemma2-2b projection shapes and at M=16 and 32 on the MLP
shape, logmac above the crossover (M > 32) at the rows PERF.md keeps:
M=128 on the MLP shape and M=256 on hymba-1.5b's seven eval shapes
(whichever kernel the checkout runs there: the tensor-core kernel since
it exists, the f32 tile kernel before), with ``torch.matmul`` of the
already-decoded fp16 planes ``[va | ra] @ [vb ; -rb]`` at the same
shapes as a yardstick of the product alone (not the same function: the
decode is done beforehand and the output is fp16); logmac at P16 L-21b
on gemma2's four projection shapes at M=256 and 512; logmac at M=128 at P32 L-21b on the five gemma2-2b shapes and at
P16 L-1b on the MLP shape (the bf16-piece kernel where the checkout has
it, the f32 tile kernel before); and one paged
flash-decode call at the serving geometry (B=4,
KV=4, G=2, hd=288, page 16, uint16 words, positions 21-40, window 4096), each with the same seeded inputs, as the
mean of 10 calls timed with CUDA events (L2 flushed first) by
``chip_smoke.time_ms``: ``ms`` with the host's issue of the call inside
the window, ``device_ms`` with the host run ahead of the device (the
device's work alone).  Prints the card's name and power limit, then one
JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# chip_smoke.py's timing helpers, from this checkout; imported before
# --src goes first on the path (chip_smoke puts this checkout's src there)
sys.path.insert(0, os.path.join(HERE, ".."))
from chip_smoke import card_line, random_words, time_ms  # noqa: E402

GEMMA_KN = [(2304, 9216), (2304, 2304), (2304, 1152), (9216, 2304),
            (2304, 256000)]
# hymba-1.5b's projections (K, N): in_proj, out_proj, q/o, k/v, gate/up,
# down, head; its eval step runs them at M = 256
HYMBA_KN = [(1600, 6482), (3200, 1600), (1600, 1600), (1600, 320),
            (1600, 5504), (5504, 1600), (1600, 32016)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(HERE, ".."),
                    help="root of the checkout whose port is timed")
    ap.add_argument("--tag", default="this checkout")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.abspath(args.src), "src"))
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.core import posit as P
    from repro_torch.core.engine import _pow2_scale, from_variant
    from repro_torch.kernels import _build
    from repro_torch.kernels import logmac as LM
    from repro_torch.kernels import paged_decode as PD
    from repro_torch.kernels import posit_codec as PC

    card = card_line()
    print(card, flush=True)
    _build.build_all()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush_buf = torch.empty(64 * 2**20 // 4, device=dev)

    def both(fn):
        return {"ms": time_ms(fn, flush=flush_buf.zero_),
                "device_ms": time_ms(fn, flush=flush_buf.zero_,
                                     device_only=True)}

    def bits(shape, pc):
        return random_words(shape, pc, gen)

    ecfg = from_variant(16, "L-21b")
    rows = {}
    fused = getattr(PC, "posit_encode_prescaled", None)
    for K, N in GEMMA_KN + [(4, 2304)]:
        x = torch.randn((K, N), generator=gen, device=dev) * (
            0.02 if N > 100000 else (1.0 if K == 4 else K ** -0.5))
        rows[f"parent route f32 [{K}, {N}]"] = both(
            lambda: PC.posit_encode((x / _pow2_scale(x)).contiguous(),
                                    ecfg.posit))
        rows[f"posit_encode f32 [{K}, {N}]"] = both(
            lambda: PC.posit_encode(x, ecfg.posit))
        if fused is not None:
            rows[f"encode_prescaled f32 [{K}, {N}]"] = both(
                lambda: fused(x, ecfg.posit))
        if N < 100000:
            # does a full read of x leave it in the 50 MB L2 for the next
            # pass, as the reduce launch leaves it for the encode launch?
            # The plain encode's device time after an L2 flush against
            # after a flush and a read of x (torch.sum): the difference is
            # the time its read of x spends at HBM (the 85 MB shapes, which
            # cannot stay, are the control)
            rows[f"posit_encode after a read of x f32 [{K}, {N}]"] = {
                "device_ms": time_ms(
                    lambda: PC.posit_encode(x, ecfg.posit),
                    flush=lambda: (flush_buf.zero_(), x.sum()),
                    device_only=True)}
        del x
    for M, (K, N) in [(4, kn) for kn in GEMMA_KN] + [(16, (2304, 9216)),
                                                     (32, (2304, 9216))]:
        a, b = bits((M, K), ecfg.posit), bits((K, N), ecfg.posit)
        rows[f"logmac P16 M={M} K={K} N={N}"] = both(
            lambda: LM.logmac(a, b, ecfg))
        del a, b
    for M, (K, N) in [(128, (2304, 9216))] + [(256, kn) for kn in HYMBA_KN]:
        a, b = bits((M, K), ecfg.posit), bits((K, N), ecfg.posit)
        rows[f"logmac P16 M={M} K={K} N={N}"] = both(
            lambda: LM.logmac(a, b, ecfg))
        va, ra = LM.decode_planes(a, ecfg)
        vb, rb = LM.decode_planes(b, ecfg)
        a16 = torch.cat([va, ra], 1).half()
        b16 = torch.cat([vb, -rb], 0).half()
        del a, b, va, ra, vb, rb
        rows[f"torch.matmul fp16 planes M={M} K={K} N={N}"] = both(
            lambda: torch.matmul(a16, b16))
        del a16, b16
    for M in (256, 512):
        for K, N in GEMMA_KN[:4]:
            a, b = bits((M, K), ecfg.posit), bits((K, N), ecfg.posit)
            rows[f"logmac P16 M={M} K={K} N={N}"] = both(
                lambda: LM.logmac(a, b, ecfg))
            del a, b
    for width, variant, kns in ((32, "L-21b", GEMMA_KN),
                                (16, "L-1b", GEMMA_KN[:1])):
        wcfg = from_variant(width, variant)
        for K, N in kns:
            a, b = bits((128, K), wcfg.posit), bits((K, N), wcfg.posit)
            rows[f"logmac P{width} {variant} M=128 K={K} N={N}"] = both(
                lambda: LM.logmac(a, b, wcfg))
            del a, b
    B, KV, G, hd, ps, nlp = 4, 4, 2, 288, 16, 16
    pos = torch.tensor([40, 33, 27, 21], dtype=torch.int32, device=dev)
    table = torch.zeros((B, nlp), dtype=torch.int32)
    nxt = PD.RESERVED_PAGES
    for r in range(B):
        for j in range(int(pos[r]) // ps + 1):
            table[r, j] = nxt
            nxt += 1
    table = table.to(dev)
    pc16 = P.BPOSIT16
    kp, vp = (P.to_storage(P.encode_from_float(torch.randn(
        (PD.RESERVED_PAGES + B * nlp, ps, KV, hd), generator=gen,
        device=dev), pc16), pc16).contiguous() for _ in range(2))
    q = torch.randn((B, 1, KV * G, hd), generator=gen, device=dev)
    rows["paged_flash_decode serving, pos 21-40"] = both(
        lambda: PD.paged_flash_decode(q, kp, vp, table, pos, 4096, pc=pc16,
                                      cfg_qk=ecfg, cfg_pv=ecfg, softcap=50.0))
    print(json.dumps({"tag": args.tag, "card": card, "times": rows,
                      "kernels_from": os.path.dirname(LM.__file__)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
