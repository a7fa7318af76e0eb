"""The comparison's readings on several seeds, in one process.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 3]

For each seed: the cell's set-up and a short window at its own load, as a
run makes them, then each compared call judged three ways (one JSON line
a seed): ``program``, the program's outputs (what a run compares);
``control``, the reference in bfloat16 put in the program's place (the
upper reading of each limit); ``rounding``, the reference from a state
one float32 rounding away (how far the cell's steps carry a difference
of rounding).  The benchmark's runs do not run this.  Needs the card(s).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def readings(root: str, name: str, seed: int, seconds: float,
             device) -> dict:
    """One seed's readings (see the module docstring)."""
    import torch

    from portbench.harness import refsteps, registry
    from portbench.harness.refsteps import MODES

    t0 = time.perf_counter()
    cell = registry.load_cell(root, name, seed, device)
    drv = registry.driver_class(root, cell.driver)(cell)
    drv.detail = True
    drv.setup()
    drv.sync()
    setup_s = time.perf_counter() - t0
    calls, start = 0, time.perf_counter()
    while (time.perf_counter() - start < seconds
           or len(drv.pairs) < 2):
        drv.call(calls)
        calls += 1
    drv.sync()
    drv.free()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed, "setup_s": setup_s, "calls": calls}
    for mode in MODES:
        t1 = time.perf_counter()
        out[mode] = drv.judge(mode)
        out[mode + "_s"] = time.perf_counter() - t1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, "_cache", "triton")
    import torch

    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(HERE, args.workload, seed, args.seconds,
                                  "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
