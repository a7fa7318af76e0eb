"""Runs of one cell in sets, and the spread of each end-to-end metric.

    python3 portbench/spread.py --workload <cell> --seeds 1,2,3,4,5,6 [--sets 2] [--seconds 10] [--trace 0]

Runs ``run.py`` once per seed, one process after another, ``--sets``
times with the same seeds, and prints each run's result line, then for
each set and metric the median and the spread: the distance between the
first and third quartiles (``statistics.quantiles(values, n=4)``) as a
share of the median, the measure ``BENCHMARK.json``'s bounds are set
from.  The benchmark's runs do not run this.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def spread(values: list[float]) -> tuple[float, float]:
    """(median, quartile distance over the median)."""
    med = statistics.median(values)
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / med


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--trace", type=int, default=0)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    sets = []
    for k in range(args.sets):
        runs = []
        for seed in seeds:
            p = subprocess.run(
                [sys.executable, os.path.join(HERE, "run.py"), "--workload",
                 args.workload, "--seed", str(seed), "--seconds",
                 str(args.seconds), "--trace", str(args.trace)],
                capture_output=True, text=True, check=False)
            line = p.stdout.strip().splitlines()[-1] if p.stdout.strip() \
                else "{}"
            print(f"set {k} seed {seed} rc {p.returncode} {line}",
                  flush=True)
            if p.returncode != 0:
                print(p.stderr[-3000:], flush=True)
                continue
            runs.append(json.loads(line))
        sets.append(runs)
    for k, runs in enumerate(sets):
        names = sorted({m for r in runs for m in r["metrics"]})
        for m in names:
            vals = [r["metrics"][m]["value"] for r in runs
                    if m in r["metrics"]]
            if len(vals) >= 2:
                med, sp = spread(vals)
                print(f"set {k} {m}: median {med!r} spread {sp!r} "
                      f"({len(vals)} runs)")
        print(f"set {k} correct {sum(r['correct'] for r in runs)} of "
              f"{len(runs)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
