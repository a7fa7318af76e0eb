"""The port's profiling path against the JAX repository's, on the CPU.

- The u8 row gather's plain version against the shade-parts probe's
  Pallas kernel (``scripts/profile_shade_parts.py:93-110``, copied here
  because the script builds it inside ``main``; the TPU ``memory_space``
  arguments dropped, a small block, interpret mode): bit-equal, negative
  and out-of-range indices included.
- Each of the five probes against the JAX probe function (copied from the
  same script) on the same numpy inputs at small sizes: sums of u8 values
  exactly (they are integers below 2**24 here), ``attr_take`` and
  ``onehot_mm`` within rtol 1e-5 (f32 sums in another order).
- The ``measure_*`` timers against
  ``banggameengine_tpu/utils/profiling.py``: the same calls and final
  states.
- The trace summary on a hand-made Chrome trace (exact) and on one CPU
  ``torch.profiler`` run; the stage timer and the probe script end to end
  at ``--device cpu --small``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from banggameengine_tpu.utils import profiling as jprof
from banggameengine_tpu_torch.engine import make_step_fn
from banggameengine_tpu_torch.render.pipeline import make_render_fn
from banggameengine_tpu_torch.scene.synthetic import (
    build_demo_like,
    build_falling_boxes,
)
from banggameengine_tpu_torch.scripts import gather_rows as gr
from banggameengine_tpu_torch.scripts import profile_render as prr
from banggameengine_tpu_torch.scripts import profile_shade_parts as psp
from banggameengine_tpu_torch.scripts import trace_summary as ts
from banggameengine_tpu_torch.utils import profiling as prof


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file: its ops are small, and beside
    other test processes on the same cores, threads that wait for each
    other cost far more than they save."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the JAX probes, as scripts/profile_shade_parts.py writes them --------

def _jax_pl_gather(p, tex, tb):
    """``pl_gather`` of the JAX script (without its f32 sum) for P = p rows
    of a u8[tex, W] table in blocks of tb, in interpret mode."""

    def gather_kernel(idx_ref, table_ref, out_ref):
        idx = idx_ref[:]                       # i32[TB]
        out_ref[:, :] = jnp.take(table_ref[:, :], idx, axis=0)

    @jax.jit
    def pl_gather(t_rows, idx):
        w = t_rows.shape[1]
        out = pl.pallas_call(
            gather_kernel,
            out_shape=jax.ShapeDtypeStruct((p, w), jnp.uint8),
            grid=(p // tb,),
            in_specs=[
                pl.BlockSpec((tb,), lambda i: (i,)),
                pl.BlockSpec((tex, w), lambda i: (0, 0)),
            ],
            out_specs=pl.BlockSpec((tb, w), lambda i: (i, 0)),
            interpret=True,
        )(idx, t_rows)
        return out

    return pl_gather


def _jax_probes(k):
    @jax.jit
    def attr_take(rows, idx):
        return jax.lax.optimization_barrier(jnp.take(rows, idx, axis=1)).sum(1)

    @jax.jit
    def texel_take(t, idx):
        q = jax.lax.optimization_barrier(jnp.take(t, idx, axis=1))
        return q.astype(jnp.float32).sum(1)

    @jax.jit
    def texel_rows(t, idx):
        q = jax.lax.optimization_barrier(jnp.take(t, idx, axis=0))
        return q.astype(jnp.float32).sum(0)

    @jax.jit
    def onehot_mm(slots, tabs):
        oh = (slots[..., None] == jnp.arange(k)[None, None, :]).astype(
            jnp.float32)
        out = jnp.einsum("tpk,tkc->tpc", oh, tabs,
                         preferred_element_type=jnp.float32)
        return out.sum((0, 2))

    return dict(attr_take=attr_take, texel_take=texel_take,
                texel_rows=texel_rows, onehot_mm=onehot_mm)


# ---- kernel #7: the u8 row gather -----------------------------------------

R, TB = 300, 128


@pytest.mark.parametrize("w", [16, 5])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_reference_equals_pallas_interpret(seed, w):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 256, (R, w)).astype(np.uint8)
    idx = rng.integers(-R - 5, R + 5, 4 * TB).astype(np.int32)
    idx[:8] = (-R - 5, -R - 1, -R, -1, 0, R - 1, R, R + 4)
    want = np.asarray(_jax_pl_gather(4 * TB, R, TB)(table, idx))
    got = gr.gather_rows_u8_reference(torch.as_tensor(table),
                                      torch.as_tensor(idx))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    bad = (idx < -R) | (idx >= R)
    assert bad.sum() >= 4 and (want[bad] == 255).all()


def test_gather_wrapper_runs_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(3)
    table = torch.as_tensor(rng.integers(0, 256, (37, 16)).astype(np.uint8))
    idx = torch.as_tensor(rng.integers(-45, 45, 101).astype(np.int32))
    before = gr.KERNEL.launches
    out = gr.gather_rows_u8(table, idx)
    assert gr.KERNEL.launches == before
    assert torch.equal(out, gr.gather_rows_u8_reference(table, idx))
    for bad_table, bad_idx in ((table.float(), idx), (table.int(), idx),
                               (table[0], idx), (table, idx.long()),
                               (table, idx[None]), (table, idx.to("meta")),
                               (table[:0], idx), (table, idx[:0])):
        with pytest.raises(ValueError):
            gr.gather_rows_u8(bad_table, bad_idx)
    with pytest.raises(NotImplementedError):
        gr.gather_rows_u8(table.to("meta"), idx.to("meta"))


# ---- the shade-parts probes -----------------------------------------------

@pytest.mark.parametrize("name", ["attr_take", "texel_take", "texel_rows",
                                  "onehot_mm", "pl_gather"])
def test_probe_matches_jax(name):
    s = psp.SMALL
    arrays = psp.inputs(s)
    fn, args = psp.probes("cpu", s)[name]
    got = fn(*args).numpy()
    if name == "pl_gather":
        # the whole gather as one block: the JAX grid needs TB | P
        rows = _jax_pl_gather(s.p, s.tex, s.p)(arrays["tq_rows"],
                                               arrays["tex_idx"])
        want = np.asarray(rows.astype(jnp.float32).sum(0))
    else:
        jax_args = {"attr_take": ("tri_rows", "tid"),
                    "texel_take": ("tq", "tex_idx"),
                    "texel_rows": ("tq_rows", "tex_idx"),
                    "onehot_mm": ("slot_idx", "tables")}[name]
        want = np.asarray(_jax_probes(s.k)[name](
            *(arrays[a] for a in jax_args)))
    assert got.shape == want.shape and got.dtype == np.float32
    if name in ("attr_take", "onehot_mm"):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


def test_probe_inputs_follow_the_jax_script():
    """The seed-0 draws in the JAX script's order: the texel rows are the
    transposed quads, every index in range."""
    a = psp.inputs(psp.SMALL)
    np.testing.assert_array_equal(a["tq_rows"], a["tq"].T)
    assert a["tid"].max() < psp.SMALL.t and a["tex_idx"].max() < psp.SMALL.tex
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        a["tri_rows"], rng.standard_normal((28, psp.SMALL.t)).astype(
            np.float32))


def test_profile_shade_parts_main_on_the_cpu(capsys):
    ms = psp.main(["--device", "cpu", "--small"])
    probes = ("attr_take", "texel_take", "texel_rows", "onehot_mm",
              "pl_gather")
    assert set(ms) == set(probes) | {"gather_rows_u8",
                                     "gather_rows_u8_reference",
                                     "index_select", "advanced_index",
                                     "library"}
    assert all(v > 0 for v in ms.values())
    assert ms["library"] == min(ms["index_select"], ms["advanced_index"])
    out = capsys.readouterr().out
    for probe in probes:
        assert f"{probe:12s}" in out
    assert "bound" in out


def test_gather_bound_counts_distinct_rows():
    table = torch.zeros((10, 16), dtype=torch.uint8)
    idx = torch.tensor([1, 1, -9, 3, 10, -11], dtype=torch.int32)
    ms, by = psp.gather_bound(table, idx)
    # 4 + 16 bytes per index, 2 distinct rows (1 and 3) read once
    assert by == "bytes"
    assert ms == pytest.approx((20 * 6 + 16 * 2) / prof.HBM_BYTES_PER_S
                               * 1e3)


# ---- the timers -----------------------------------------------------------

class _Counter:
    def __init__(self, make):
        self.calls = 0
        self.make = make

    def __call__(self, *args):
        self.calls += 1
        return self.make(*args)


@pytest.mark.parametrize("which", ["measure_throughput", "measure_trials"])
def test_measure_calls_match_jax(which):
    kw = dict(calls=4, warmup=3) if which == "measure_throughput" else dict(
        calls=4, warmup=3, trials=3)
    fn_j = _Counter(lambda x: x + 1)
    fn_t = _Counter(lambda x: x + 1)
    res_j = getattr(jprof, which)(fn_j, jnp.zeros(3), **kw)
    res_t = getattr(prof, which)(fn_t, torch.zeros(3), **kw)
    assert fn_t.calls == fn_j.calls == 3 + 4 * kw.get("trials", 1)
    assert type(res_t) is type(res_j)
    times = res_t if isinstance(res_t, list) else [res_t]
    assert len(times) == kw.get("trials", 1) and all(t > 0 for t in times)


@pytest.mark.parametrize("which", ["measure_throughput_chained",
                                   "measure_trials_chained"])
@pytest.mark.parametrize("as_tuple", [False, True])
def test_measure_chained_final_state_matches_stepping(which, as_tuple):
    def step(s, inc):
        return (s + inc, "events") if as_tuple else s + inc

    kw = dict(calls=5, warmup=2) if which == "measure_throughput_chained" \
        else dict(calls=5, warmup=2, trials=4)
    n = 2 + 5 * kw.get("trials", 1)
    s0 = np.arange(4, dtype=np.float32)
    t_j, s_j = getattr(jprof, which)(step, jnp.asarray(s0), 1.5, **kw)
    t_t, s_t = getattr(prof, which)(step, torch.as_tensor(s0), 1.5, **kw)
    by_hand = torch.as_tensor(s0)
    for _ in range(n):
        by_hand = by_hand + 1.5
    assert torch.equal(s_t, by_hand)
    np.testing.assert_array_equal(np.asarray(s_j), by_hand.numpy())
    assert type(t_t) is type(t_j)


def test_measure_needs_a_tensor_and_device_sync_ignores_the_cpu():
    with pytest.raises(ValueError):
        prof.measure_throughput(lambda: None, calls=1)
    prof.device_sync({"a": [torch.zeros(2)], "b": None})
    assert list(prof.tensor_leaves(
        {"a": (torch.zeros(1), [torch.ones(2)]), "b": 3})) != []


# ---- the trace summary ----------------------------------------------------

def _hand_made_trace(path, warm_up):
    """Two executions: kernels a, b (overlapping), a, a copy; host ops.
    With ``warm_up``, a traced warm-up before them and a cool-down after
    them, as ``trace_and_summarize`` makes them."""
    def x(cat, name, ts_, dur, pid=0):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts_, "dur": dur,
                "pid": pid, "tid": 7}

    def corr(e, c):
        e["args"] = {"correlation": c}
        return e

    # with the warm-up: its kernel "w" placed by its launch at -38 though
    # the card's clock puts it at +1; kernel "c" of execution 0 launched at
    # +2 and put at -1, before the first host op (no busy time)
    events = [
        x("user_annotation", "warm-up", -40.0, 30.0, pid=1),
        corr(x("cuda_runtime", "cudaLaunchKernel", -38.0, 1.0, pid=1), 1),
        corr(x("kernel", "w", 1.0, 2.0), 1),
        x("cpu_op", "sync", -15.0, 1.0, pid=1),
        x("user_annotation", "execution 0", 0.0, 25.0, pid=1),
        x("user_annotation", "execution 1", 25.0, 25.0, pid=1),
        corr(x("cuda_runtime", "cudaLaunchKernel", 2.0, 0.5, pid=1), 3),
        corr(x("kernel", "c", -1.0, 1.0), 3),
        # the cool-down: its kernel "z" placed by its launch at +51 though
        # the card's clock puts it at +44, inside the window
        x("user_annotation", "cool-down", 50.0, 10.0, pid=1),
        corr(x("cuda_runtime", "cudaLaunchKernel", 51.0, 1.0, pid=1), 5),
        corr(x("kernel", "z", 44.0, 3.0), 5),
        x("cpu_op", "sync", 53.0, 5.0, pid=1),
    ] if warm_up else []
    events += [
        {"ph": "M", "name": "process_name", "pid": 0, "args": {}},
        x("cpu_op", "outer", 0.0, 50.0, pid=1),
        x("cpu_op", "inner", 19.0, 5.0, pid=1),
        x("cuda_runtime", "cudaLaunchKernel", 9.0, 1.0, pid=1),
        x("kernel", "a", 10.0, 5.0),
        x("kernel", "b", 12.0, 6.0),
        x("kernel", "a", 30.0, 2.0),
        x("gpu_memcpy", "Memcpy DtoH", 40.0, 1.0),
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler", "ts": -100.0,
         "dur": 1000.0, "pid": "Spans", "tid": "x"},
    ]
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


@pytest.mark.parametrize("warm_up", [False, True])
def test_parse_trace_on_a_hand_made_trace(tmp_path, capsys, warm_up):
    _hand_made_trace(tmp_path / "t.json", warm_up)
    s = ts.parse_trace(str(tmp_path), reps=2)       # the directory form
    assert s == ts.summarize(ts.load_trace(str(tmp_path / "t.json")), 2)
    # window 0..50 us; busy [10, 18] + [30, 32] + [40, 41] = 11 us
    assert s["window_ms"] == pytest.approx(0.025)
    assert s["busy_ms"] == pytest.approx(0.0055)
    assert s["busy_share"] == pytest.approx(0.22)
    assert s["launches"] == (2.0 if warm_up else 1.5)
    # by total time, ties in the order they start
    assert [(k["name"], k["ms"], k["count"]) for k in s["kernels"]] == [
        ("a", pytest.approx(0.0035), 1.0), ("b", pytest.approx(0.003), 0.5)
    ] + ([("c", pytest.approx(0.0005), 0.5)] if warm_up else []) + [
        ("Memcpy DtoH", pytest.approx(0.0005), 0.5)]
    # each gap's innermost host op at its midpoint: 24, 5, 45.5, 36 us
    ops = (["inner", "execution 0", "execution 1", "execution 1"] if warm_up
           else ["inner", "outer", "outer", "outer"])
    assert [(g["ms"], g["at_ms"], g["host_op"]) for g in s["gaps"]] == [
        (pytest.approx(0.012), pytest.approx(0.018), ops[0]),
        (pytest.approx(0.010), 0.0, ops[1]),
        (pytest.approx(0.009), pytest.approx(0.041), ops[2]),
        (pytest.approx(0.008), pytest.approx(0.032), ops[3])]
    assert ts.main(["--parse", str(tmp_path / "t.json"), "2"]) == s
    out = capsys.readouterr().out
    assert "launches per execution" in out and "22.0 %" in out


def test_trace_of_a_cpu_program(tmp_path):
    x = torch.ones((16, 16))
    s = ts.trace_and_summarize(lambda: (x @ x).sum(), (), str(tmp_path))
    assert s["launches"] == 0 and s["kernels"] == [] and s["busy_ms"] == 0
    assert s["window_ms"] > 0 and s["gaps"][0]["ms"] > 0
    names = {e.get("name") for e in ts.load_trace(str(tmp_path))}
    assert {"warm-up", "execution 0", "execution 1", "execution 2",
            "cool-down", "aten::matmul"} <= names
    with pytest.raises(RuntimeError):
        prof.stop_trace()


@pytest.mark.parametrize("name", ts.PROGRAMS)
def test_trace_programs_build_and_run(name):
    fn, args = ts.build(name, "cpu", small=True)
    out = fn(*args)
    if name == "stress":
        assert int(out.step_idx) == int(args[0].step_idx) + 5
    elif name == "manyworld":
        assert out.pos.shape == (4, 16, 3)
        assert out.step_idx.tolist() == [25] * 4
    elif name in ("demo", "dense"):
        assert int(out.step_idx) == 25
        assert out.pos.shape == ((8, 3) if name == "demo" else (16, 3))
        char = 0 if name == "demo" else 12
        assert float(out.pos[char, 1]) < 7.0        # the character falls
    elif name == "tick":
        state, frame, _ = out
        assert tuple(frame.shape) == prr.SMALL_WH[::-1] + (4,)
        assert int(state.step_idx) == 21
    elif name in ("app", "overlay"):
        img, state = out              # one display frame after the 1-s track
        assert img.shape == (72, 128, 4) and int(state.step_idx) == 124
    else:
        w, h = prr.SMALL_WH
        assert tuple(out.shape) == ((h, w) if name == "depth" else (h, w, 4))


@pytest.mark.parametrize("name", ["demo", "dense"])
def test_count_ops_is_steps_times_one_step(name):
    """A dispatch's op count is its steps times one step's: the dense
    route dispatches the same ops whatever the state (no data-dependent
    branch on the host)."""
    fn, (state, inp) = ts.build(name, "cpu", small=True)
    if name == "demo":
        static, kw = build_demo_like(device="cpu")[1], {}
    else:
        static = build_falling_boxes(12, seed=1, with_character=True,
                                     with_trigger=True, device="cpu")[1]
        kw = dict(trigger_mode="shape")
    n5 = ts.main([name, "--device", "cpu", "--small", "--count-ops"])["ops"]
    assert n5 == ts.count_ops(fn, (state, inp)) > 0
    assert n5 == 5 * ts.count_ops(make_step_fn(static, **kw), (state, inp))


# ---- the frame stage timer ------------------------------------------------

@pytest.fixture(scope="module")
def small_stages():
    stages = prr.stages("cpu", small=True)
    return stages, {k: fn(*args) for k, (fn, args) in stages.items()}


@pytest.mark.parametrize("route", list(prr.ROUTES))
def test_frame_stage_equals_make_render_fn(small_stages, route):
    stages, outs = small_stages
    rs, args, (w, h) = prr.showcase("cpu", small=True)
    frame = make_render_fn(rs, w, h, bin_capacity=prr.BIN_CAPACITY,
                           **prr.ROUTES[route])(*args)
    assert frame.dtype == torch.uint8 and tuple(frame.shape) == (h, w, 4)
    assert torch.equal(outs[f"frame_{route}"], frame)


def test_stages_agree_with_each_other(small_stages):
    """Both visibility routes give the depth-only frame's depth (the small
    frame's two tiles all get the heavy pass), the shade alone gives the
    flat frame, the light pass covers every tile."""
    stages, outs = small_stages
    assert torch.equal(outs["walk"], outs["depth"])
    assert torch.equal(outs["full_vis"], outs["depth"])
    assert torch.equal(outs["shade"], outs["frame_flat"])
    assert outs["light"][0].shape[0] == outs["bin"].ids.shape[0] == 2
    assert int(outs["bin"].overflow) == 0


def test_profile_render_main_on_the_cpu(capsys):
    ms = prr.main(["--device", "cpu", "--small"])
    assert list(ms) == ["bin", "walk", "full_vis", "light", "depth", "shade",
                        "frame_tiled", "frame_fused", "frame_flat"]
    assert all(v > 0 for v in ms.values())
    out = capsys.readouterr().out
    assert "tiles=2 " in out and "overflow=0" in out
    for stage in ms:
        assert f"{stage:12s}" in out
