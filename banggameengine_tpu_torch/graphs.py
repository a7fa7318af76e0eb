"""Captured programs: the port's counterpart of ``jax.jit``.

Every factory of the JAX package returns a jitted program, one dispatch a
call.  A :class:`Program` is the same thing on the card: a function of a
tree of tensors (tensors, tuples, lists, dicts and dataclasses of them,
with hashable Python values as static arguments), captured once into a
``torch.cuda.CUDAGraph`` for each input signature and replayed on every
later call.

- **Signature.**  The tree's structure, its Python values and each
  tensor's shape, dtype and device.  A new signature is a new capture,
  which is JAX's recompile.
- **Capture.**  The call's tensors are copied into the program's input
  buffers; one eager call on a side stream builds what the function
  builds on first use (the hand kernels' libraries, library handles and
  workspaces); then the function is captured on that stream into a graph
  with its own memory pool.  A capture that fails raises: nothing steps
  down to eager.  Host synchronisation is allowed while a program
  captures (it is set-up, as a compile is), and any host read inside the
  function breaks the capture.
- **Buffers.**  Inputs are the program's own buffers.  A call copies the
  caller's tensors into them, unless the caller passed the buffer itself,
  as when a donated state is passed back; then nothing is copied.  The
  arguments in ``by_ref`` are captured by reference: their tensors are the
  buffers (a factory's bound scene, so that in-place writes to it reach
  the graph), and another tensor of the same shape is copied into them.
- **Donation.**  With ``donate=True`` the function returns a tuple whose
  first element is the new value of the first argument; the graph writes
  it into the first argument's buffers, and the call returns those
  buffers and the graph's own output tensors, valid until the program's
  next call, as JAX's donation consumes the state passed in.  Without it
  the call returns clones of the outputs.  ``call(*args, times=n)``
  replays a donated program ``n`` times in a row: ``n`` steps, each
  reading the state the last one wrote.  ``enter`` and ``leave`` (a
  donated program's) change the carried form: a call runs ``enter`` on
  the first argument once, the function ``n`` times on what it made,
  and ``leave`` once, back into the first argument's buffers, as a
  ``lax.scan`` between a reshape and its inverse.  On the card they are
  three graphs: ``enter``, the function (replayed) and ``leave``.
- **Routes.**  Outside :func:`eager`, on tensors on the card, a call
  captures or replays; otherwise it runs the function eagerly, a donated
  one ``n`` times with its first output fed back in as its first
  argument.  The eager route is the CPU's and the reference.
- **Launch counts.**  Each graph records how many launches of each hand
  kernel of the registry (``cuda_build.KERNELS``) it holds, and every
  replay adds them to the kernels' ``launches`` counts, so the counts
  read what the card ran: the replays and the captures' warm-ups, which
  :data:`warmup_launches` counts apart.

:func:`eager` is the counterpart of ``jax.disable_jit()``: inside it
every factory runs its eager code.  On the CPU the factories are always
eager.  :data:`stats` counts what the programs ask of the host
(captures, replays, input copies and output clones) and the host's
seconds in the captures, ``capture_s`` (each with its eager warm-up).
:func:`host_launches` sums the calls that reach the card.  While a
profiler records, each call of a program is a host span
``program:<name>`` (:func:`utils.profiling.span`), so a trace places
every graph launch in the program that issued it.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import torch

from banggameengine_tpu_torch.cuda_build import KERNELS
from banggameengine_tpu_torch.utils.profiling import span

Tensor = torch.Tensor

_eager_depth = 0

# what the programs asked of the host, since the process started, and its
# seconds in captures
stats = {"captures": 0, "replays": 0, "copies": 0, "clones": 0,
         "capture_s": 0.0}

# the hand-kernel launches of the captures' eager warm-ups, by the
# registry's key (real launches, in the kernels' counts too)
warmup_launches: collections.Counter = collections.Counter()

# A stand-in for the graph class on CPU tensors: the CPU tests install one
# to run the capture logic without a card (None: the CPU is eager).  It
# takes ``capture(body, stream, inputs) -> outputs`` (``inputs``: the
# input buffers, which a capture must leave as it found them) and
# ``replay()``.
cpu_graph_class = None

@contextlib.contextmanager
def eager():
    """Run every factory's eager code inside (``jax.disable_jit()``)."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1


def is_eager() -> bool:
    """Whether the calls run inside :func:`eager`."""
    return _eager_depth > 0


def host_launches() -> int:
    """Replays, copies and clones the programs have issued."""
    return stats["replays"] + stats["copies"] + stats["clones"]


def enabled(*trees) -> bool:
    """Whether a call on these trees runs as a captured program: not
    inside :func:`eager`, and their tensors on a CUDA device (or on the
    CPU with a stand-in graph class installed)."""
    return _captures(_device(flatten(trees)[0]))


def _captures(device: torch.device | None) -> bool:
    if is_eager() or device is None:
        return False
    return device.type == "cuda" or (device.type == "cpu"
                                     and cpu_graph_class is not None)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

_TENSOR = "tensor"


def _walk(x, leaves: list):
    """The hashable structure of ``x``; its tensors appended to
    ``leaves``."""
    if isinstance(x, Tensor):
        leaves.append(x)
        return _TENSOR
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        names = tuple(f.name for f in dataclasses.fields(x))
        return (type(x), names,
                tuple(_walk(getattr(x, n), leaves) for n in names))
    if isinstance(x, (tuple, list)):
        return (type(x), None, tuple(_walk(v, leaves) for v in x))
    if isinstance(x, dict):
        keys = tuple(x)
        return (dict, keys, tuple(_walk(x[k], leaves) for k in keys))
    hash(x)          # a static argument must be hashable
    return ("value", x)


def flatten(tree) -> tuple[list, object]:
    """(tensor leaves in order, hashable structure)."""
    leaves: list = []
    return leaves, _walk(tree, leaves)


def unflatten(spec, leaves):
    """The tree of ``spec`` with ``leaves`` in its tensor places."""
    it = iter(leaves)

    def build(s):
        if s == _TENSOR:
            return next(it)
        if s[0] == "value":
            return s[1]
        kind, names, children = s
        values = [build(c) for c in children]
        if kind is dict:
            return dict(zip(names, values))
        if names is None:
            return kind(values)
        return kind(**dict(zip(names, values)))

    return build(spec)


def _device(leaves) -> torch.device | None:
    """The first CUDA device among the leaves, else the first leaf's."""
    cuda = next((t.device for t in leaves if t.device.type == "cuda"), None)
    return cuda or (leaves[0].device if leaves else None)


def _signature(leaves, spec):
    return spec, tuple((tuple(t.shape), t.dtype, t.device) for t in leaves)


def signature(tree):
    """The hashable key of a tree: structure, Python values, and each
    tensor's shape, dtype and device."""
    return _signature(*flatten(tree))


def _same_memory(a: Tensor, b: Tensor) -> bool:
    return a is b or (a.device == b.device and a.data_ptr() == b.data_ptr()
                      and a.shape == b.shape and a.stride() == b.stride()
                      and a.dtype == b.dtype)


def copy_into(dst, src) -> bool:
    """Copy the tensors of ``src`` into those of ``dst`` when the two trees
    have one signature (True); False, and nothing copied, otherwise."""
    if signature(dst) != signature(src):
        return False
    for d, s in zip(flatten(dst)[0], flatten(src)[0]):
        if not _same_memory(d, s):
            d.copy_(s)
            stats["copies"] += 1
    return True


def clone_tree(tree):
    """The tree with every tensor cloned (a program's output clones,
    counted in :data:`stats`)."""
    leaves, spec = flatten(tree)
    stats["clones"] += len(leaves)
    return unflatten(spec, [t.clone() for t in leaves])


def owned(tree):
    """The tree with every tensor cloned, uncounted: a caller's own copy
    of a donated result (which the program's next call overwrites), or
    inside a capture the graph's own memory."""
    leaves, spec = flatten(tree)
    return unflatten(spec, [t.clone() for t in leaves])


# ---------------------------------------------------------------------------
# graphs
# ---------------------------------------------------------------------------

class _CudaGraph:
    """One ``torch.cuda.CUDAGraph`` on its own memory pool."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, body, stream, inputs):
        del inputs                      # a capture runs nothing
        with torch.cuda.stream(stream):
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = body()
            except BaseException:
                # end the capture so the stream is usable, then raise the
                # function's own error
                with contextlib.suppress(RuntimeError):
                    self.graph.capture_end()
                raise
            self.graph.capture_end()
        return out

    def replay(self) -> None:
        self.graph.replay()


_side_streams: dict = {}


@contextlib.contextmanager
def _capture_stream(device: torch.device):
    """A side stream that waits for the current one, with host syncs
    allowed (a capture is set-up); the current stream waits for it at the
    end.  On the CPU, nothing."""
    if device.type != "cuda":
        yield None
        return
    stream = _side_streams.get(device)
    if stream is None:
        stream = _side_streams[device] = torch.cuda.Stream(device)
    current = torch.cuda.current_stream(device)
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    stream.wait_stream(current)
    try:
        yield stream
    finally:
        current.wait_stream(stream)
        torch.cuda.set_sync_debug_mode(mode)


def _write_back(dst, new, name: str):
    """Write the tree ``new`` into the tensors of ``dst`` (its donated
    buffers, of the same structure and shapes); returns ``dst``."""
    bufs, spec = flatten(dst)
    leaves, new_spec = flatten(new)
    if new_spec != spec or [t.shape for t in leaves] != [
            t.shape for t in bufs]:
        raise ValueError(f"{name}: the donated argument's new value has "
                         f"another structure or shape")
    # an output that is a view of another buffer is cloned first, so no
    # write-back reads a buffer already written
    ptrs = {b.untyped_storage().data_ptr() for b in bufs}
    leaves = [n if n is b or n.untyped_storage().data_ptr() not in ptrs
              else n.clone() for n, b in zip(leaves, bufs)]
    for b, n in zip(bufs, leaves):
        if n is not b:
            b.copy_(n)
    return dst


class _Entry:
    """One capture of a program: its buffers, graphs and outputs."""

    def __init__(self, program: "Program", args: tuple, device):
        t0 = time.perf_counter()
        p = self.program = program
        self.bufs: list = []
        per_arg = []
        for i, a in enumerate(args):
            leaves, spec = flatten(a)
            per_arg.append((spec, len(leaves)))
            for t in leaves:
                if i in p.by_ref:
                    self.bufs.append(t)
                else:
                    buf = torch.empty_like(t, device=device)
                    buf.copy_(t)
                    stats["copies"] += 1
                    self.bufs.append(buf)
        it = iter(self.bufs)
        self.args = tuple(unflatten(spec, [next(it) for _ in range(n)])
                          for spec, n in per_arg)
        self.graphs: list = []          # (graph, held launch counts)
        with _capture_stream(device) as stream:
            counters = list(KERNELS.values())
            before = [k.launches for k in counters]
            p.run_eager(self.args, 1)        # warm-up: builds, handles
            for k, n0 in zip(counters, before):
                if k.launches != n0:
                    warmup_launches[k.key] += k.launches - n0

            def capture(body, inputs):
                graph = (_CudaGraph() if device.type == "cuda"
                         else cpu_graph_class())
                before = [k.launches for k in counters]
                try:
                    return graph.capture(body, stream, inputs)
                finally:
                    # the capture launched nothing: its counts go to the
                    # replays
                    held = []
                    for k, n0 in zip(counters, before):
                        if k.launches != n0:
                            held.append((k, k.launches - n0))
                            k.launches = n0
                    self.graphs.append((graph, held))

            if p.enter is None:
                self.out = capture(self._body, self.bufs)
            else:
                first, rest = self.args[0], self.args[1:]
                # the carry is the enter graph's own output (a clone where
                # ``enter`` returns a view of an input)
                self.carry = capture(lambda: owned(p.enter(first)),
                                     self.bufs)
                carry_bufs = flatten(self.carry)[0]
                out = capture(lambda: self._step(rest),
                              self.bufs + carry_bufs)
                capture(lambda: _write_back(first, p.leave(self.carry),
                                            p.name), self.bufs)
                self.out = (first, *out[1:])
        stats["captures"] += 1
        stats["capture_s"] += time.perf_counter() - t0
        p.captures += 1

    def _step(self, rest):
        out = self.program.fn(self.carry, *rest)
        return (_write_back(self.carry, out[0], self.program.name),
                *out[1:])

    def _body(self):
        out = self.program.fn(*self.args)
        if not self.program.donate:
            return out
        if not isinstance(out, (tuple, list)):
            raise TypeError(f"{self.program.name}: a donating function "
                            f"returns a tuple (new first argument, ...)")
        return (_write_back(self.args[0], out[0], self.program.name),
                *out[1:])

    def load(self, leaves) -> None:
        for buf, t in zip(self.bufs, leaves):
            if not _same_memory(buf, t):
                buf.copy_(t)
                stats["copies"] += 1

    def _replay(self, i: int) -> None:
        graph, held = self.graphs[i]
        graph.replay()
        stats["replays"] += 1
        for kernel, n in held:
            kernel.launches += n

    def run(self, times: int) -> None:
        """``times`` replays of the function's graph (between those of
        ``enter`` and ``leave``)."""
        if self.program.enter is None:
            for _ in range(times):
                self._replay(0)
            return
        self._replay(0)
        for _ in range(times):
            self._replay(1)
        self._replay(2)


class Program:
    """``fn`` captured per input signature and replayed (see the module
    docstring).  ``donate``: the first argument is consumed and its new
    value written in place; ``by_ref``: positions of arguments captured by
    reference; ``enter`` and ``leave``: a donated program's carried form.
    ``captures`` counts this program's captures."""

    def __init__(self, fn, *, donate: bool = False, by_ref=(),
                 name: str | None = None, enter=None, leave=None):
        if (enter is None) != (leave is None) or (
                enter is not None and not donate):
            raise ValueError("enter and leave come together, on a "
                             "donating program")
        self.fn = fn
        self.donate = donate
        self.by_ref = frozenset(by_ref)
        self.name = name or getattr(fn, "__name__", "program")
        self.enter, self.leave = enter, leave
        self.captures = 0
        self._entries: dict = {}
        self._span = "program:" + self.name

    def run_eager(self, args: tuple, times: int):
        """The eager route: ``fn`` on ``args``, ``times`` times in a row
        when it donates (its first output fed back as its first
        argument), between ``enter`` and ``leave``."""
        first, rest = args[0], args[1:]
        if self.enter is not None:
            first = self.enter(first)
        for _ in range(times):
            out = self.fn(first, *rest)
            if self.donate:
                first = out[0]
        if self.leave is not None:
            return (self.leave(first), *out[1:])
        return out

    def __call__(self, *args, times: int = 1):
        if times < 1 or (times > 1 and not self.donate):
            raise ValueError(f"{self.name}: a call runs once, or (a "
                             f"donating program) times >= 1; got {times}")
        with span(self._span):
            return self._call(args, times)

    def _call(self, args: tuple, times: int):
        leaves, spec = flatten(args)
        device = _device(leaves)
        if not _captures(device):
            return self.run_eager(args, times)
        key = _signature(leaves, spec)
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = _Entry(self, args, device)
        else:
            entry.load(leaves)
        entry.run(times)
        return entry.out if self.donate else clone_tree(entry.out)
