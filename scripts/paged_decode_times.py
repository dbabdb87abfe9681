"""Paged flash-decode of any checkout of the port: the kernel's time near
the end of max_len 256 and its distance from the plain version over many
draws, so that two versions can be compared in one call.

    python3 scripts/paged_decode_times.py                   # this checkout
    python3 scripts/paged_decode_times.py --src DIR --tag parent

``--src`` names the root of another checkout (its ``src/repro_torch`` is
imported and its kernels are built under its own ``build/``).  Times one
call at the serving geometry (B=4, KV=4, G=2, hd=288, page 16, uint16
words, P16 L-21b, softcap 50, window 4096) at positions 255, 254, 250 and
252: ``ms`` with the host's issue inside the window and ``device_ms``
with the host run ahead of the device (``chip_smoke.time_ms``, L2 flushed
first, mean of 20 calls), and the plain version's ``plain_ms``.  Then the
kernel against the plain version on seeds 0-8 at that geometry (windows
None, 4096 and 24) and at (KV, G, hd) = (8, 5, 128), (32, 1, 64) and (8,
8, 128) (windows None and 24, no softcap): the largest max |kernel -
plain| of each geometry, and how many draws exceed 1e-3.  Prints the
card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))
from chip_smoke import PAGED_GEOMS, card_line, time_ms  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(HERE, ".."),
                    help="root of the checkout whose port is timed")
    ap.add_argument("--tag", default="this checkout")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.abspath(args.src), "src"))
    import torch
    if not torch.cuda.is_available():
        print("paged_decode_times: no CUDA device available",
              file=sys.stderr)
        return 2
    from repro_torch.core import posit as P
    from repro_torch.core.engine import from_variant
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_decode as PD

    card = card_line()
    print(card, flush=True)
    _build.build_all()
    dev = torch.device("cuda", 0)
    ecfg = from_variant(16, "L-21b")
    pc16 = P.BPOSIT16
    B, ps, max_len = 4, 16, 256
    nlp = max_len // ps

    def page_table(pos):
        tab = torch.full((B, nlp), PD.NULL_PAGE, dtype=torch.int32)
        nxt = PD.RESERVED_PAGES
        for r in range(B):
            for j in range(int(pos[r]) // ps + 1):
                tab[r, j] = nxt
                nxt += 1
        return tab.to(dev)

    def pool(gen, KV, hd):
        out = []
        for _ in range(2):
            f = torch.randn((PD.RESERVED_PAGES + B * nlp, ps, KV, hd),
                            generator=gen, device=dev)
            f[:PD.RESERVED_PAGES] = 0
            out.append(P.to_storage(P.encode_from_float(f, pc16),
                                    pc16).contiguous())
        return out

    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    kp, vp = pool(gen, 4, 288)
    q = torch.randn((B, 1, 8, 288), generator=gen, device=dev)
    pos = torch.tensor([255, 254, 250, 252], dtype=torch.int32, device=dev)
    kw = dict(pc=pc16, cfg_qk=ecfg, cfg_pv=ecfg, softcap=50.0)
    call = (q, kp, vp, page_table(pos), pos, 4096)
    times = {
        "ms": time_ms(lambda: PD.paged_flash_decode(*call, **kw), reps=20,
                      flush=flush),
        "device_ms": time_ms(lambda: PD.paged_flash_decode(*call, **kw),
                             reps=20, flush=flush, device_only=True),
        "plain_ms": time_ms(lambda: PD.paged_flash_decode_plain(*call, **kw),
                            reps=3, flush=flush)}

    spread = {}
    serve_pos = torch.tensor([37, 100, 250, 5], dtype=torch.int32,
                             device=dev)
    table = page_table(serve_pos)
    geoms = [(4, 2, 288, 50.0, (None, 4096, 24))] + [
        (KV, G, hd, None, (None, 24)) for KV, G, hd in PAGED_GEOMS]
    for seed in range(9):
        g = torch.Generator(device=dev)
        g.manual_seed(1000 + seed)
        for KV, G, hd, cap, windows in geoms:
            kpg, vpg = pool(g, KV, hd)
            qg = torch.randn((B, 1, KV * G, hd), generator=g, device=dev)
            for window in windows:
                kwg = dict(kw, softcap=cap)
                got = PD.paged_flash_decode(qg, kpg, vpg, table, serve_pos,
                                            window, **kwg)
                want = PD.paged_flash_decode_plain(qg, kpg, vpg, table,
                                                   serve_pos, window, **kwg)
                spread.setdefault(f"KV={KV} G={G} hd={hd}", []).append(
                    float((got - want).abs().max()))
    print(json.dumps({
        "tag": args.tag, "card": card,
        "pos_250_255": times,
        "kernel_vs_plain": {k: {"max": max(v), "draws": len(v),
                                "over_1e-3": sum(d > 1e-3 for d in v)}
                            for k, v in spread.items()},
        "kernels_from": os.path.dirname(PD.__file__)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
