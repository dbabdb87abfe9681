"""Fault-injection campaign entry point of the port: live serving traffic
under seeded bit flips.

  python -m repro_torch.launch.faultcamp --smoke
  python -m repro_torch.launch.faultcamp --smoke --guard --device cpu

``--smoke`` runs one width (16) and two fault plans (regime_run and
fraction roles) on the ``lax_ref`` backend and asserts the paper's
orderings: bounded token corruption strictly below unbounded at equal flip
rate, and regime-role corruption strictly above fraction-role.  ``--guard``
reruns every cell through ``guarded:faulty:<backend>``; with ``--smoke`` it
also asserts detection >= 0.9 on regime-bit faults and zero false
positives on the clean arm.

Runs on ``--device cuda`` (the default) and raises when no CUDA device is
present.  The campaign serves in ``mode="posit"``, which runs no kernel.
"""
from __future__ import annotations

import argparse
import json
import logging

import torch

from repro_torch.launch import pin_exact_f32
from repro_torch.reliability.campaign import run_campaign


def _fmt(x) -> str:
    return "n/a" if x is None else f"{x:.2f}"


def main(argv=None) -> dict:
    """Run the campaign, print its table and return the campaign dict."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="one width (16), 2 fault plans, assert orderings")
    ap.add_argument("--widths", type=int, nargs="+", default=[16, 32])
    ap.add_argument("--roles", nargs="+",
                    default=["regime_run", "fraction"])
    ap.add_argument("--rate", type=float, default=5e-4,
                    help="per-word flip probability (equal across plans)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="lax_ref")
    ap.add_argument("--operand", default="a",
                    help="a = activations (slot-local blast radius), "
                         "b = weights (shared across co-scheduled slots)")
    ap.add_argument("--guard", action="store_true",
                    help="add the guarded:faulty:<backend> defense arm")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="",
                    help="write the campaign JSON here (sorted keys)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available; "
                           "pass --device cpu to run on the CPU")
    pin_exact_f32()

    widths = [16] if args.smoke else args.widths
    requests = min(args.requests, 6) if args.smoke else args.requests
    camp = run_campaign(widths=widths, roles=tuple(args.roles),
                        rate=args.rate, n_requests=requests,
                        max_new=args.max_new, batch=args.batch,
                        seed=args.seed, backend=args.backend,
                        operand=args.operand, guard=args.guard,
                        device=args.device)

    for label, fmt in camp["formats"].items():
        row = "  ".join(
            f"{role}: ter={m['token_error_rate']:.4f} "
            f"corrupt={m['corrupted_requests']}/{m['requests']}"
            for role, m in fmt["roles"].items())
        print(f"{label:<9} (R={fmt['regime_bound']}): {row}")
        if args.guard:
            grow = "  ".join(
                f"{role}: detect={_fmt(m['guarded']['detection_rate'])} "
                f"recover={_fmt(m['guarded']['request_recovery_rate'])} "
                f"residual_ter={m['guarded']['residual_token_error_rate']:.4f}"
                for role, m in fmt["roles"].items())
            print(f"{'guarded':<9} (fp={fmt['guard_clean']['false_positives']}"
                  f"): {grow}")
    print("summary:", json.dumps(camp["summary"], sort_keys=True))

    if args.out:
        with open(args.out, "w") as f:
            json.dump(camp, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.out}")

    ordering = camp["summary"]["ordering"]
    if args.smoke:
        assert ordering["bounded_below_unbounded"], (
            "bounded posit must corrupt strictly fewer tokens than "
            f"unbounded at equal flip rate: {camp['summary']}")
        assert ordering["regime_worse_than_fraction"], (
            "regime-run flips must corrupt strictly more than fraction "
            f"flips: {camp['summary']}")
        print("fault-smoke orderings OK")
    elif not all(ordering.values()):
        raise SystemExit(f"ordering violated: {ordering}")

    if args.guard:
        g = camp["summary"]["guard"]
        if args.smoke:
            assert g["false_positives"] == 0, (
                f"ABFT false positives on the clean arm: {g}")
            assert (g["detection_rate_regime"] is not None
                    and g["detection_rate_regime"] >= 0.9), (
                f"regime-bit detection rate below 0.9: {g}")
            print("guard-smoke detection/false-positive bars OK")
        elif g["false_positives"]:
            raise SystemExit(f"guard false positives: {g}")
    return camp


if __name__ == "__main__":
    main()
