"""The spread of a cell's metrics over two sets of runs, and the bounds
they allow.

  python3 portbench/spread.py 'out/set1_*.out' 'out/set2_*.out'

Each argument is a glob of files whose last JSON line is a run's result
line.  For every metric it prints:

* each set's spread: the distance between the first and third quartiles
  (``statistics.quantiles(values, n=4)``) as a share of the median;
* the bound by the rule of five: five times the wider of the two, never
  under 0.01, at most 0.25;
* the tightness reading: the mean of the two sets' spreads, each taken
  without its run farthest from the median (a bound under twice it is
  too tight);
* the looseness reading: the spread of all runs together (a bound over
  eight times it is too loose);
* the second set's median against the first's."""
from __future__ import annotations

import glob
import json
import statistics
import sys


def spread(values) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def without_farthest(values):
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return [v for i, v in enumerate(values) if i != far]


def load(pattern: str) -> list[dict]:
    rows = []
    for path in sorted(glob.glob(pattern)):
        lines = [ln for ln in open(path).read().splitlines()
                 if ln.startswith("{")]
        if lines:
            rows.append(json.loads(lines[-1]))
    return rows


def readings(sets: list[list[float]]) -> dict:
    per = [spread(v) for v in sets]
    tight = statistics.mean(spread(without_farthest(v)) for v in sets)
    every = [x for v in sets for x in v]
    meds = [statistics.median(v) for v in sets]
    return {"spreads": per, "rule_of_five": min(max(5 * max(per), 0.01),
                                                0.25),
            "tightness": tight, "looseness": spread(every),
            "medians": meds, "median_shift": (meds[1] - meds[0]) / meds[0]}


def main(argv) -> int:
    sets = [load(p) for p in argv[1:3]]
    names = sorted({k for s in sets for r in s for k in r["metrics"]})
    for name in names:
        vals = [[r["metrics"][name]["value"] for r in s
                 if name in r["metrics"]] for s in sets]
        if min(len(v) for v in vals) < 3:
            continue
        r = readings(vals)
        print(f"{name}: spreads {[round(x, 4) for x in r['spreads']]}, "
              f"rule of five {r['rule_of_five']:.4f}, tightness "
              f"{r['tightness']:.4f} (bound >= {2 * r['tightness']:.4f}), "
              f"looseness {r['looseness']:.4f} (bound <= "
              f"{8 * r['looseness']:.4f}), medians "
              f"{[round(m, 4) for m in r['medians']]} "
              f"({r['median_shift']:+.4f})")
        for v in vals:
            print("   ", [round(x, 4) for x in v])
    for s in sets:
        print("correct:", [r["correct"] for r in s])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
