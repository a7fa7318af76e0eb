"""Profiling and tracing helpers.

Counterpart of ``banggameengine_tpu/utils/profiling.py``:

- :func:`device_sync`: waits for the card that holds an output;
- :func:`measure_throughput` and its chained and multi-trial forms: the
  per-call time of a queued window of calls.  On the card the window is
  timed by two CUDA events on the current stream (the device's own clock,
  from the first queued call to the end of the last one); for CPU tensors
  by ``time.perf_counter``.  Which clock is read follows from where the
  warm-up output lies;
- :func:`measure_device_trials`: the card's own time per call, with the
  host's per-call work kept out of the window (for kernels that take less
  time than their wrapper's host work);
- :func:`bound_ms`: the least time the card could take for given bytes
  and operations;
- :class:`span`: a named stage of a step or a frame, a host range on
  the profiler's timeline while it records, and on the card the marker
  kernels of ``csrc/spans.cu`` around each stage of
  :data:`DEVICE_SPANS`, which a captured graph replays, so a trace of
  replays splits their device time by stage;
- :func:`start_trace` / :func:`stop_trace`: one whole-program
  ``torch.profiler`` trace (host ops and, on a card, its kernels),
  exported as a Chrome trace.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import time

import torch

from banggameengine_tpu_torch import cuda_build

# the published H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def tensor_leaves(out):
    """The tensors in ``out``: a tensor, or tuples, lists, dicts and
    dataclasses of them, nested, in order."""
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from tensor_leaves(v)
    elif isinstance(out, dict):
        for v in out.values():
            yield from tensor_leaves(v)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            yield from tensor_leaves(getattr(out, f.name))


def _cuda_device(out) -> torch.device | None:
    """The device of the first CUDA tensor among the leaves of ``out``."""
    return next((t.device for t in tensor_leaves(out)
                 if t.device.type == "cuda"), None)


def device_sync(out) -> None:
    """Wait until the card that holds the first CUDA tensor of ``out`` has
    finished all queued work; nothing for CPU tensors."""
    device = _cuda_device(out)
    if device is not None:
        torch.cuda.synchronize(device)


def _windows(step, state, calls: int, warmup: int, trials: int):
    """``trials`` windows of ``calls`` queued ``state = step(state)`` each,
    after ``warmup`` untimed calls and one sync.  Returns (per-call seconds
    of each window, final state)."""
    for _ in range(max(warmup, 1)):
        state = step(state)
    if next(tensor_leaves(state), None) is None:
        raise ValueError("the timed function must return a tensor (or a "
                         "structure of tensors): its device says which "
                         "clock to read")
    device = _cuda_device(state)
    device_sync(state)
    times = []
    for _ in range(max(trials, 1)):
        if device is None:
            t0 = time.perf_counter()
            for _ in range(calls):
                state = step(state)
            times.append((time.perf_counter() - t0) / calls)
            continue
        stream = torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        for _ in range(calls):
            state = step(state)
        end.record(stream)
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / calls)
    return times, state


def _chained(fn, rest):
    def step(s):
        out = fn(s, *rest)
        return out[0] if isinstance(out, tuple) else out
    return step


def measure_throughput(fn, *args, calls: int = 20, warmup: int = 2) -> float:
    """Per-call seconds of ``fn(*args)`` over ``calls`` queued calls, after
    ``warmup`` calls and one sync; on the card by CUDA events."""
    times, _ = _windows(lambda _: fn(*args), None, calls, warmup, 1)
    return times[0]


def measure_throughput_chained(fn, state, *rest, calls: int = 20,
                               warmup: int = 2):
    """Like :func:`measure_throughput` for step-like fns.

    ``fn(state, *rest)`` must return the next state (or a tuple whose first
    element is).  Returns (seconds_per_call, final_state)."""
    times, state = _windows(_chained(fn, rest), state, calls, warmup, 1)
    return times[0], state


def measure_trials(fn, *args, calls: int = 5, warmup: int = 2,
                   trials: int = 5):
    """Dispersion-aware :func:`measure_throughput`: the per-call seconds of
    each of ``trials`` timed windows of ``calls`` queued calls."""
    times, _ = _windows(lambda _: fn(*args), None, calls, warmup, trials)
    return times


def measure_device_trials(fn, *args, calls: int = 10, warmup: int = 2,
                          trials: int = 5) -> list[float]:
    """Per-call seconds of the card's own work for ``fn(*args)``, whose
    output lies on the card, over ``trials`` windows of ``calls`` queued
    calls.  Each window is queued behind a sleep kernel that outlasts the
    host's queueing, so the card runs the window back to back and the two
    CUDA events leave out the host's per-call work (checks, allocation,
    the launch call).  A window whose sleep ran out before the host had
    queued it all is timed again behind a sleep twice as long.

    The sleep kernel is PyTorch's private ``torch.cuda._sleep(cycles)``
    (a spin of that many clock cycles; PyTorch's own tests use it): a
    PyTorch without it makes this function raise, and every device time
    with it.  The first sleep is sized for ~0.1 ms a call at the H100's
    clock; the doubling above covers a slower clock or host."""
    if not hasattr(torch.cuda, "_sleep"):
        raise RuntimeError("measure_device_trials: this PyTorch has no "
                           "torch.cuda._sleep to hold the window")
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    device = _cuda_device(out)
    if device is None:
        raise ValueError("measure_device_trials: the timed function must "
                         "return a tensor on the card")
    torch.cuda.synchronize(device)
    stream = torch.cuda.current_stream(device)
    cycles = 200_000 * calls        # ~0.1 ms a call at the H100's clock
    times = []
    while len(times) < max(trials, 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record(stream)
        for _ in range(calls):
            fn(*args)
        end.record(stream)
        late = start.query()        # the card already waits for the host
        end.synchronize()
        if late:
            cycles *= 2
            if cycles > 1 << 36:    # ~30 s of sleep: the host never keeps up
                raise RuntimeError("measure_device_trials: the host could "
                                   "not queue the window ahead of the card")
            continue
        times.append(start.elapsed_time(end) / 1e3 / calls)
    return times


def measure_trials_chained(fn, state, *rest, calls: int = 5,
                           warmup: int = 2, trials: int = 5):
    """Dispersion-aware :func:`measure_throughput_chained`: ``trials``
    windows back to back, each of ``calls`` queued steps.  Returns
    ``(per_call_seconds_list, final_state)``; report their median and
    spread, since one window cannot tell a loaded host from a change."""
    return _windows(_chained(fn, rest), state, calls, warmup, trials)


def bound_ms(n_bytes: float, ops: float) -> tuple[float, str]:
    """The least time one H100 could take for a piece of work, in ms, and
    what sets it: ``n_bytes`` (each input read once, each output written
    once) over the memory rate, or ``ops`` f32 operations over the peak
    rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# The stages whose device time a trace can split out of a captured graph:
# ``span(name)`` marks each of them on the card with the marker kernels of
# ``csrc/spans.cu`` (in this order, then ``bge_span_end``).
DEVICE_SPANS = (
    "physics.characters",
    "physics.broadphase",
    "physics.narrowphase",
    "physics.solver",
    "physics.integrate",
    "physics.triggers",
    "ecs.transforms",
    "manyworld.flatten",
    "manyworld.unflatten",
    "render.raster",
    "render.shade",
    "physics.joints",
    "physics.motors",
)
_MARKER_INDEX = {name: i for i, name in enumerate(DEVICE_SPANS)}
_MARKER_END = len(DEVICE_SPANS)
_SPANS_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "csrc", "spans.cu")


def marker_kernel(name: str) -> str:
    """The name of the kernel that marks the start of the span ``name``."""
    return "bge_span_" + name.replace(".", "_")


def profiler_on() -> bool:
    """Whether a ``torch.profiler`` (or autograd profiler) is recording."""
    return torch.autograd._profiler_enabled()


def _check_count(lib: ctypes.CDLL) -> None:
    """Raise unless the library holds a marker for each of
    :data:`DEVICE_SPANS` and one for the end."""
    lib.bge_span_count.restype = ctypes.c_int
    if lib.bge_span_count() != _MARKER_END + 1:
        raise RuntimeError(
            f"spans: the library holds {lib.bge_span_count()} markers, "
            f"the wrapper expects {_MARKER_END + 1}")


# the markers are no hand kernels: built and launched as one, counted apart
# from the registry, so no kernel's launch count holds a marker
SPAN_LIBRARY = cuda_build.Library(
    "bge_spans", _SPANS_SOURCE, [ctypes.c_int, ctypes.c_void_p],
    symbols="bge_span", on_load=_check_count)


class span:
    """A named stage: ``with span(name, device): ...``.

    While a profiler records, the stage is a host ``record_function``
    range; otherwise the host pays one check.  Where ``name`` is one of
    :data:`DEVICE_SPANS` and ``device`` is a CUDA device, the stage is
    also marked on the card: :func:`marker_kernel` ``(name)`` is launched
    on the current stream at entry and ``bge_span_end`` at exit, eagerly
    or into the graph being captured (so every replay runs them).  The
    markers read and write no data.  Spans do not nest: the device ops
    between a marker and the next are that marker's stage's."""

    __slots__ = ("name", "device", "_range", "_marked")

    def __init__(self, name: str, device: torch.device | None = None):
        self.name = name
        self.device = device

    def __enter__(self):
        self._range = None
        if profiler_on():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._marked = (self.device is not None
                        and self.device.type == "cuda"
                        and self.name in _MARKER_INDEX)
        if self._marked:
            SPAN_LIBRARY.launch(self.device, _MARKER_INDEX[self.name])
        return self

    def __exit__(self, *exc):
        if self._marked:
            SPAN_LIBRARY.launch(self.device, _MARKER_END)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


_trace: dict = {}   # the running trace: its profiler and its directory


def start_trace(log_dir: str) -> None:
    """Start the process's one trace: host ops, and the card's kernels when
    there is a card.  :func:`stop_trace` writes it into ``log_dir``."""
    if _trace:
        raise RuntimeError("a trace is already running")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _trace.update(prof=prof, log_dir=log_dir)


def stop_trace() -> str:
    """Stop the trace and export it as a Chrome trace; returns its path."""
    if not _trace:
        raise RuntimeError("no trace is running")
    prof, log_dir = _trace.pop("prof"), _trace.pop("log_dir")
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path
