"""Readings for the limits of ``correct``: the widest logit gap of sound
runs over many seeds, and of the control, all in one process (set-up is
long, so the kernels are built once).

  python3 portbench/control.py --workload yi6b-doc --seconds 20 \\
      --seeds 11,12,13 --width 16      # sound runs: the lower reading
  python3 portbench/control.py --workload yi6b-doc --seconds 20 \\
      --seeds 11,12,13 --width 8       # the control

The control is the program's own lower-precision path switched on: the
cell served at the next posit width below the configuration's (P8 for
P16), its tokens judged against the configuration's reference as a run's
are.  The benchmark's runs never run this script.  Prints one JSON line
per seed: the gap, the tokens compared, the reference's seconds."""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path.pop(0)
sys.path.insert(0, os.path.dirname(HERE))

from portbench import run as R  # noqa: E402


def readings(workload: str, seeds, seconds: float, width: int,
             device: str = "cuda", program=None, cell=None):
    """One reading per seed: (seed, gap, tokens compared, correct)."""
    c = cell or R.load_cell(workload)
    P = program or R.import_program()
    out = []
    for seed in seeds:
        res = R.run_cell(c, seed, seconds, False, device=device, program=P,
                         width=width)
        row = {"seed": seed, "width": width,
               "mean_gap": res["gaps"]["mean"],
               "widest_gap": res["gaps"]["widest"],
               "first_gap": res["gaps"]["first"],
               "off_best": res["gaps"]["off_best"],
               "tokens": res["checks"]["compared_tokens"]["value"],
               "short_or_failed": res["checks"]["short_or_failed"]["value"],
               "reference_s": res["ref_s"], "correct": res["correct"],
               "output_tok_s": res["e2e"]["output_tok_s"]}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--width", type=int, required=True)
    args = ap.parse_args(argv)
    readings(args.workload, [int(s) for s in args.seeds.split(",")],
             args.seconds, args.width)
    return 0


if __name__ == "__main__":
    sys.exit(main())
