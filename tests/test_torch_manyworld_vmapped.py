"""The port's vmapped many-world step against the JAX package's.

4 worlds, 25 steps, through the JAX package's
``make_sharded_many_world_step`` on a one-device mesh (one step a call)
and the port's (``torch.func.vmap`` of its ``engine_step``), from the same
numpy state and inputs: ``build_falling_boxes(8, with_character=True,
with_trigger=True)`` with zero input and with per-world input (the inputs
of ``tests/test_flat_manyworld.py:67``), and the parented and capsule
scenes of ``tests/test_flat_manyworld.py:193, :226``.

Bars: float fields within 2e-4, the JAX package's own flat-against-
vmapped bar over 25 steps (``tests/test_flat_manyworld.py:44-57``);
booleans and the step count exact.  The port's flat step against its
vmapped step: the same bar.  The port against itself is bit-equal: each
world of the vmapped step equals the single-world step with that world's
input, ``world_minor=True`` equals the world-major layout, and the step
on a world mesh of 2 gloo ranks equals the step without a mesh (the
metrics' mean over the ranks within 1e-6 of the mean over the worlds,
whose sum runs in another order).  No functorch BatchedFallback warning
is raised anywhere: the tests make it an error.

The ranks run in freshly spawned processes, which import this module:
it imports neither JAX nor the JAX package at module level.
"""

import dataclasses
import sys
import warnings

import numpy as np
import pytest
import torch

from banggameengine_tpu_torch import convert
from banggameengine_tpu_torch.engine import make_step_fn
from banggameengine_tpu_torch.parallel import manyworld, ranks
from banggameengine_tpu_torch.state import InputFrame

WORLDS, STEPS = 4, 25
ATOL = 2e-4
FLOAT_FIELDS = ("pos", "quat", "lin_vel", "ang_vel", "char_vel_y", "world")
EXACT_FIELDS = ("char_on_ground", "trigger_overlap", "trigger_active",
                "alive", "step_idx")
CASES = (("boxes", "zero"), ("boxes", "drive"), ("parented", "zero"),
         ("capsules", "zero"))
FALLBACK = ".*batching rule.*"   # functorch's BatchedFallback warning


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(kind: str) -> dict:
    inp = dict(move_forward=np.zeros(WORLDS, np.float32),
               move_right=np.zeros(WORLDS, np.float32),
               jump=np.zeros(WORLDS, bool), sprint=np.zeros(WORLDS, bool),
               cam_yaw=np.zeros(WORLDS, np.float32))
    if kind == "drive":
        inp.update(move_forward=np.float32([0.0, 1.0, 1.0, 0.0]),
                   cam_yaw=np.float32([0.0, 0.5, 1.0, 1.5]),
                   jump=np.array([False, False, True, False]))
    return inp


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _jax_scene(name: str):
    """One world of the scene, built by the JAX package: (state, static)
    as JAX dataclasses."""
    from banggameengine_tpu.scene.synthetic import build_falling_boxes

    if name == "boxes":
        return build_falling_boxes(8, with_character=True,
                                   with_trigger=True)
    if name == "parented":
        from test_flat_manyworld import _parented_world

        return _parented_world()
    from test_physics import build_world
    from test_torch_capsule_slots import CAPSULE_BODIES

    return build_world(CAPSULE_BODIES, capacity=8)


@pytest.fixture(scope="module")
def scenes() -> dict:
    return {name: tuple(_np(o) for o in _jax_scene(name))
            for name in ("boxes", "parented", "capsules")}


def _port(state_np, static_np, inp_np, device="cpu"):
    ts = convert.world_state_from_numpy(state_np, device)
    tst = convert.static_scene_from_numpy(static_np, device)
    return (ts, tst, manyworld.replicate_state(ts, WORLDS),
            convert.input_frame_from_numpy(inp_np, device))


def _run_vmapped(state_np, static_np, inp_np, **kw):
    """The port's vmapped step, STEPS steps in one call, with the
    BatchedFallback warning raised as an error."""
    _, tst, bs, bi = _port(state_np, static_np, inp_np)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=FALLBACK)
        step = manyworld.make_sharded_many_world_step(
            tst, num_steps=STEPS, **kw)
        return step(bs, bi)


@pytest.fixture(scope="module")
def port_runs(scenes) -> dict:
    return {(name, kind): _run_vmapped(*scenes[name], _inputs(kind))
            for name, kind in CASES}


@pytest.fixture(scope="module")
def jax_runs(scenes) -> dict:
    import jax
    import jax.numpy as jnp

    from banggameengine_tpu.parallel import manyworld as jax_mw
    from banggameengine_tpu.state import InputFrame as JaxInputFrame

    mesh = jax_mw.make_world_mesh(jax.devices()[:1])
    out = {}
    for name in ("boxes", "parented", "capsules"):
        js, jst = _jax_scene(name)
        step = jax_mw.make_sharded_many_world_step(jst, mesh, num_steps=1)
        for kind in [k for n, k in CASES if n == name]:
            bs = jax.tree.map(jnp.array, jax_mw.replicate_state(js, WORLDS))
            bi = JaxInputFrame(**{k: jnp.asarray(v)
                                  for k, v in _inputs(kind).items()})
            for _ in range(STEPS):
                bs = step(bs, bi)
            out[(name, kind)] = _np(bs)
    return out


def _assert_match(a: dict, b: dict, atol: float, what: str) -> None:
    for name in FLOAT_FIELDS:
        np.testing.assert_allclose(a[name], b[name], atol=atol,
                                   err_msg=f"{what}: {name}")
    for name in EXACT_FIELDS:
        np.testing.assert_array_equal(a[name], b[name],
                                      err_msg=f"{what}: {name}")


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_vmapped_matches_jax(case, port_runs, jax_runs):
    got = convert.world_state_to_numpy(port_runs[case])
    _assert_match(got, jax_runs[case], ATOL, "port vs JAX")
    assert np.isfinite(got["pos"]).all()


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_port_flat_matches_port_vmapped(case, scenes, port_runs):
    name, kind = case
    ts, tst, bs, bi = _port(*scenes[name], _inputs(kind))
    flat = manyworld.make_flat_many_world_step(
        tst, WORLDS, ts.comp_mask, num_steps=STEPS)(bs, bi)
    _assert_match(convert.world_state_to_numpy(flat),
                  convert.world_state_to_numpy(port_runs[case]), ATOL,
                  "flat vs vmapped")


def test_vmapped_worlds_equal_the_single_world_step(scenes, port_runs):
    """Each world of the vmapped step, bit for bit, is the port's own
    single-world step driven by that world's input row."""
    state_np, static_np = scenes["boxes"]
    inp = _inputs("drive")
    ts, tst, _, _ = _port(state_np, static_np, inp)
    got = convert.world_state_to_numpy(port_runs[("boxes", "drive")])
    step = make_step_fn(tst)
    for w in range(WORLDS):
        s = ts
        one = convert.input_frame_from_numpy(
            {k: v[w] for k, v in inp.items()}, "cpu")
        for _ in range(STEPS):
            s, _ = step(s, one)
        for name, a in convert.world_state_to_numpy(s).items():
            np.testing.assert_array_equal(got[name][w], a,
                                          err_msg=f"world {w}: {name}")
    # and the per-world inputs moved the characters apart
    assert not np.allclose(got["pos"][0, 8], got["pos"][1, 8])


def test_world_minor_is_the_same_step(scenes, port_runs):
    got = _run_vmapped(*scenes["boxes"], _inputs("drive"), world_minor=True)
    ref = convert.world_state_to_numpy(port_runs[("boxes", "drive")])
    for name, a in convert.world_state_to_numpy(got).items():
        np.testing.assert_array_equal(a, ref[name], err_msg=name)


def test_world_metrics_match_jax(jax_runs):
    """``world_metrics`` on one numpy batch through both packages, and the
    step's ``with_metrics`` means over the worlds."""
    import jax.numpy as jnp

    from banggameengine_tpu.parallel import manyworld as jax_mw
    from banggameengine_tpu.state import WorldState as JaxWorldState

    batch = jax_runs[("boxes", "drive")]
    jm = jax_mw.world_metrics(
        JaxWorldState(**{k: jnp.asarray(v) for k, v in batch.items()}))
    tm = manyworld.world_metrics(convert.world_state_from_numpy(batch, "cpu"))
    assert set(jm) == set(tm)
    for k in jm:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-6, err_msg=k)


def test_with_metrics_means_over_worlds(scenes, port_runs):
    out, metrics = _run_vmapped(*scenes["boxes"], _inputs("drive"),
                                with_metrics=True)
    per_world = manyworld.world_metrics(out)
    for k, v in per_world.items():
        assert float(metrics[k]) == pytest.approx(float(v.mean()), rel=1e-6)
        assert np.isfinite(float(metrics[k]))


def test_no_batched_fallback_warning(scenes):
    """One vmapped step of each scene, every warning recorded: none is
    functorch's per-world fallback loop."""
    for name in ("boxes", "parented", "capsules"):
        _, tst, bs, bi = _port(*scenes[name], _inputs("drive"))
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            manyworld.make_sharded_many_world_step(tst)(bs, bi)
        fallback = [str(w.message) for w in seen
                    if "batching rule" in str(w.message)]
        assert not fallback, (name, fallback)


# --- the world mesh on gloo ranks ----------------------------------------


def _mesh_rank(rank, world_size, state_np, static_np, inp_np):
    """One rank: the vmapped step with metrics on a world mesh of
    ``world_size`` gloo ranks; returns the gathered state, the metrics
    and whether JAX stayed out of this process."""
    mesh = manyworld.make_world_mesh(device_type="cpu")
    _, tst, bs, bi = _port(state_np, static_np, inp_np)
    step = manyworld.make_sharded_many_world_step(
        tst, mesh, num_steps=STEPS, with_metrics=True)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=FALLBACK)
        out, metrics = step(manyworld.shard_batched(bs, mesh),
                            manyworld.shard_batched(bi, mesh))
    local_worlds = int(out.pos.to_local().shape[0])
    return dict(
        state=convert.world_state_to_numpy(ranks.full(out)),
        metrics={k: float(v) for k, v in metrics.items()},
        local_worlds=local_worlds,
        jax_free=not any(m == "jax" or m.startswith(("jax.",
                                                      "banggameengine_tpu."))
                         or m == "banggameengine_tpu" for m in sys.modules))


def test_world_mesh_of_two_ranks(scenes, port_runs, tmp_path):
    inp = _inputs("drive")
    results = ranks.run_ranks(_mesh_rank, 2, *scenes["boxes"], inp,
                              device="cpu", store_dir=str(tmp_path))
    ref = convert.world_state_to_numpy(port_runs[("boxes", "drive")])
    per_world = manyworld.world_metrics(port_runs[("boxes", "drive")])
    for r in results:
        assert r["jax_free"]
        assert r["local_worlds"] == WORLDS // 2
        for name, a in r["state"].items():
            np.testing.assert_array_equal(a, ref[name], err_msg=name)
        for k, v in per_world.items():
            assert r["metrics"][k] == pytest.approx(float(v.mean()),
                                                    rel=1e-6)
