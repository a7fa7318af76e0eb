"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Finds the cell in ``BENCHMARK.json`` and its files under this folder
(``workloads/``, ``configs/``, ``traffic/``, ``metrics/``), builds the
program through the traffic driver's entry in the port
(``banggameengine_tpu_torch``), runs the set-up, measures for
``--seconds`` seconds, then compares the compared calls with the plain
reference (``reference/``) and prints one JSON line: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics, read from a ``torch.profiler``
trace of a fixed count of the window's calls), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
beside its limit, which also close standard error.

Exits 3 without the card(s) the cell asks for, 4 if JAX or the JAX
package was imported, 5 without the program beside it; the compile
caches stay inside the checkout.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# the program's kernel caches, at fixed paths inside the checkout (the
# port's nvcc libraries build under banggameengine_tpu_torch/_build/)
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
          "torch_extensions", "CUDA_CACHE_PATH": "nv"}
FORBIDDEN = ("jax", "jaxlib", "flax", "banggameengine_tpu")
TRACE_AFTER = 2          # window calls before the traced ones
AHEAD = 2                # calls the host may queue ahead of the card
TOP = 10


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (whole) is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out or "nvidia-smi gave nothing"


def _readings_ok(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def run_cell(root: str, bench: dict, name: str, seed: int, seconds: float,
             trace_on: bool, device, t0: float, fault=None,
             control: bool = False) -> dict:
    """One run of the cell ``name`` on ``device``; returns the result
    line's object.  ``fault`` plants one of the driver's faults under the
    timed path, ``control`` puts the bfloat16 reference in the program's
    place (the tests)."""
    import torch

    from portbench.harness import registry, roofline, trace
    from portbench.harness.refsteps import merge_max

    cell = registry.load_cell(root, name, seed, device)
    e2e_entries, pl_entries = registry.cell_metrics(bench, name)
    chips = next(w["chips"] for w in bench["workloads"] if w["name"] == name)
    drv = registry.driver_class(root, cell.driver)(cell, fault=fault)
    drv.setup()
    drv.sync()
    setup_s = time.perf_counter() - t0

    from banggameengine_tpu_torch import graphs

    on_card = torch.device(device).type == "cuda"
    calls, prof, launches, queued = 0, None, [], []
    start = time.perf_counter()
    # the window runs its length, and on until the compared call and the
    # traced calls have run
    while (time.perf_counter() - start < seconds or calls <= drv.check_at
           or (trace_on and prof is None)):
        if trace_on and prof is None and calls >= TRACE_AFTER:
            first = calls + 1
            drv.tracing = True

            def traced_call(i):
                drv.tracing = 0 <= i < drv.trace_calls
                drv.call(first + i if i >= 0 else first - 1)

            prof = trace.traced(
                traced_call, drv.trace_calls, drv.sync,
                before=lambda: launches.append(graphs.host_launches()),
                after=lambda: launches.append(graphs.host_launches()))
            drv.tracing = False
            calls += drv.trace_calls + 2
            continue
        drv.call(calls)
        calls += 1
        if on_card:
            # the host stays at most AHEAD calls ahead, so the window ends
            # near its length and not after a long queue drains
            queued.append(torch.cuda.Event())
            queued[-1].record()
            if len(queued) > AHEAD:
                queued.pop(0).synchronize()
    drv.sync()
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    metrics, traced_device, extra = {}, {}, {}
    if not trace_on:
        values = {"setup_s": setup_s, **drv.end_to_end(calls, window_s)}
        for m in e2e_entries:
            if m["name"] not in values:
                raise KeyError(f"{name}: driver {cell.driver!r} gives no "
                               f"{m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    notes = drv.notes()
    if trace_on:
        events = trace.events(prof, cell.out_dir)
        del prof
        summary = trace.summarize(events)
        ctx = {"summary": summary, "events": events,
               "calls": drv.trace_calls,
               "steps": drv.trace_calls * drv.steps_per_call,
               "host_launches": launches[1] - launches[0], "driver": drv}
    drv.free()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if trace_on:
        for m in pl_entries:
            v = registry.metric_reader(root, m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        extra["breakdown"] = {
            "device_ops": [[k["name"], k["ms"] / 1e3]
                           for k in summary["kernels"][:TOP]],
            "idle_gaps": [[g["host_op"], g["ms"] / 1e3]
                          for g in summary["gaps"][:TOP]]}
        traced_device = {"busy_s": summary["busy_ms"] / 1e3,
                 "window_s": summary["window_ms"] / 1e3}
        notes.append(
            f"traced {drv.trace_calls} calls ({ctx['steps']} steps): "
            f"{summary['launches']} kernels, device busy "
            f"{summary['busy_ms']:.4f} of {summary['window_ms']:.4f} ms")
        for key in ("broadphase_roofline", "walk_roofline",
                    "resolve_roofline"):
            if any(k.startswith(key) for k in metrics):
                notes.append(f"rooflines against the H100 SXM's published "
                             f"{roofline.HBM_BYTES_PER_S:.3g} B/s "
                             f"and {roofline.F32_OPS_PER_S:.3g} "
                             f"f32 op/s; this card: {power_limit()}")
                break

    if [p.label for p in drv.pairs] != ["start", "window"]:
        raise RuntimeError(f"{name}: compared calls {drv.pairs!r}")
    pairs = drv.judge("control" if control else "program")
    checks_each = [{k: {"value": v, "limit": cell.limits[k]}
                    for k, v in r.items()} for r in pairs]
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in merge_max(pairs).items()}
    failed = sum(not _readings_ok(c) for c in checks_each)
    name_dev = torch.cuda.get_device_name() if on_card else "cpu"
    result = {
        "correct": failed == 0,
        "attempted": calls,
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": name_dev,
                   "count": chips, "memory_peak_bytes": peak,
                   **traced_device},
        **extra,
        "checks": checks,
    }
    for line in notes:
        print(line, file=sys.stderr)
    print(f"{calls} calls in {window_s:.3f} s; set-up {setup_s:.3f} s; "
          f"{name_dev}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    return result


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(HERE, "_cache", sub)
    bench_path = os.path.join(REPO, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in {bench_path}",
              file=sys.stderr)
        return 2
    try:
        import banggameengine_tpu_torch  # noqa: F401  (the program)
    except ImportError as e:
        print(f"the program is not here: {e}", file=sys.stderr)
        return 5
    import torch

    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count = {torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    result = run_cell(HERE, bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", T0)
    loaded = forbidden_modules()
    if loaded:
        print(f"modules loaded that the benchmark must not load: {loaded}",
              file=sys.stderr)
        return 4
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
