"""Where a guarded gemma2-2b FULL prefill pass spends its time on the card.

    python3 scripts/guard_breakdown.py                      # this checkout
    python3 scripts/guard_breakdown.py --src DIR --tag parent

``--src`` names the root of another checkout (its ``src/repro_torch`` is
imported and its kernels are built under its own ``build/``).  Builds
gemma2-2b FULL from seed 0 (the weights chip_smoke serves), then prefills
one 16-token prompt on ``cuda`` and on ``guarded:cuda`` under the
launcher's guard (``GuardConfig(record="full")``, as phase 3b serves) in
turns (plain, guarded, guarded, plain), as chip_smoke's guard-share line
does.  Then one more guarded pass with each step of the guard timed
alone, ``torch.cuda.synchronize()`` before and after it: the base
contraction, ``_quantize_like`` (and within it the fused entry
``posit_quantize_prescaled`` where the checkout has it, else
``_pow2_scale``), ``violation`` (the ABFT sums and check dots),
``sentinel_counts`` (and within it ``posit_sentinels``, else
``word_flags``); what is left of the pass is the guard's other host work.
Prints the card's name and power limit, then one JSON line.

Run this checkout and its parent in one call, in turns, to compare them:
``python3 scripts/guard_breakdown.py --src build/parent --tag parent``.
"""
from __future__ import annotations

import argparse
import collections
import importlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))
from chip_smoke import card_line  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(HERE, ".."),
                    help="root of the checkout whose port is timed")
    ap.add_argument("--tag", default="this checkout")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.abspath(args.src), "src"))
    import torch
    if not torch.cuda.is_available():
        print("guard_breakdown: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.configs import gemma2_2b
    from repro_torch.core import engine as E
    from repro_torch.core.engine import from_variant
    from repro_torch.kernels import _build
    from repro_torch.kernels import posit_codec as PC
    from repro_torch.launch import pin_exact_f32
    from repro_torch.models.layers import Ctx
    from repro_torch.models.transformer import Model
    from repro_torch.numerics import NumericsContext
    from repro_torch.numerics import backends as B
    from repro_torch.reliability import guards as G
    # the module, not the package's re-exported ``ece`` function
    ECE = importlib.import_module("repro_torch.reliability.ece")
    assert repro_torch.__file__.startswith(os.path.abspath(args.src)), \
        repro_torch.__file__

    pin_exact_f32()
    card = card_line()
    print(card, flush=True)
    _build.build_all()
    dev = torch.device("cuda", 0)
    ecfg = from_variant(16, "L-21b")
    model = Model(gemma2_2b.FULL, device=dev)
    params = model.init(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    ids = torch.randint(0, gemma2_2b.FULL.vocab, (1, 16), generator=gen,
                        device=dev)
    guarded = B.guarded("cuda", G.GuardConfig(record="full")).name

    def prefill(backend):
        nctx = NumericsContext.from_ecfg(ecfg, backend=backend)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            model.prefill(params, ids, Ctx(numerics=nctx),
                          model.init_cache(1, 16, "uint16"))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    pass_s = collections.defaultdict(list)
    for backend in ("cuda", guarded, guarded, "cuda"):
        pass_s[backend].append(prefill(backend))

    # each step of the guard alone, synchronised around every call
    secs = collections.Counter()
    calls = collections.Counter()

    def timed(name, fn):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                secs[name] += time.perf_counter() - t0
                calls[name] += 1
        return wrapped

    cuda_cls = type(B.get_backend("cuda"))
    # the guard's steps, and within them the fused entries (this tree) or
    # the torch chains they replaced (the parent)
    patches = [(cuda_cls, "dot_general"), (G, "_quantize_like"),
               (E, "_pow2_scale"), (G, "violation"), (G, "sentinel_counts"),
               (ECE, "word_flags")] + [
        (PC, name) for name in ("posit_quantize_prescaled", "posit_sentinels")
        if hasattr(PC, name)]
    saved = [(obj, name, getattr(obj, name)) for obj, name in patches]
    for obj, name, fn in saved:
        setattr(obj, name, timed(name, fn))
    _build.reset_launches()
    try:
        synced = prefill(guarded)
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    steps = {k: round(v, 4) for k, v in secs.items()}
    timed_top = (secs["dot_general"] + secs["_quantize_like"]
                 + secs["violation"] + secs["sentinel_counts"])
    out = {"tag": args.tag, "card": card,
           "pass_s": {k: [round(t, 4) for t in v] for k, v in pass_s.items()},
           "synced_pass_s": round(synced, 4), "step_s": steps,
           "step_calls": dict(calls),
           "rest_s": round(synced - timed_top, 4), "launches": launches}
    print(f"[guard breakdown] {args.tag}: {card}: passes {out['pass_s']}; "
          f"one synchronised guarded pass {synced:.4f} s: {steps} "
          f"(calls {dict(calls)}), the rest {out['rest_s']} s; "
          f"launches {launches}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
