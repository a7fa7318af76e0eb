"""The PyTorch port's state, conversion, scene builder and small modules
against the JAX package, on the same numpy inputs.

Tolerances: math and geometry atol=1e-6 (f32 rounding of a few ops, where
JAX's CPU compiler fuses multiply-adds and PyTorch does not); builder
rotations atol=2.5e-7 (f32 sin/cos of the two libraries and the fused
multiply-adds of the quaternion product differ by up to 2 ulp, 1.2e-7, on
components in [0.5, 1)); everything integer, boolean or copied is exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banggameengine_tpu import engine as jax_engine
from banggameengine_tpu import math3d as jax_math3d
from banggameengine_tpu.ecs import transform as jax_transform
from banggameengine_tpu.physics import shapes as jax_shapes
from banggameengine_tpu.physics import triggers as jax_triggers
from banggameengine_tpu.scene.synthetic import (
    build_falling_boxes as jax_build_falling_boxes,
)
from banggameengine_tpu.state import InputFrame as JaxInputFrame
from banggameengine_tpu_torch import convert, engine, math3d
from banggameengine_tpu_torch.ecs import transform
from banggameengine_tpu_torch.physics import shapes, triggers
from banggameengine_tpu_torch.scene.synthetic import (
    build_box_render,
    build_falling_boxes,
)


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _assert_dicts_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_convert_round_trip_is_bit_exact():
    state, static = jax_build_falling_boxes(6, seed=2, with_character=True,
                                            with_trigger=True)
    s_np, st_np = _np(state), _np(static)
    # make every float bit pattern count: odd values, a negative zero
    s_np["lin_vel"] = np.random.default_rng(0).standard_normal(
        s_np["lin_vel"].shape).astype(np.float32)
    s_np["ang_vel"] = s_np["ang_vel"].copy()
    s_np["ang_vel"][0, 0] = -0.0
    ts = convert.world_state_from_numpy(s_np, "cpu")
    tst = convert.static_scene_from_numpy(st_np, "cpu")
    assert ts.comp_mask.dtype == torch.int32 and tst.mask.dtype == torch.int32
    assert int(tst.mask[0]) == -1          # 0xFFFFFFFF as a bit view
    back = convert.world_state_to_numpy(ts)
    _assert_dicts_equal(s_np, back)
    assert np.signbit(back["ang_vel"][0, 0])
    _assert_dicts_equal(st_np, convert.static_scene_to_numpy(tst))
    inp = _np(JaxInputFrame(move_forward=jnp.float32(0.25),
                            move_right=jnp.float32(-1.0),
                            jump=jnp.asarray(True), sprint=jnp.asarray(False),
                            cam_yaw=jnp.float32(1.5)))
    _assert_dicts_equal(inp, convert.input_frame_to_numpy(
        convert.input_frame_from_numpy(inp, "cpu")))


@pytest.mark.parametrize("n,extras", [(8, False), (100, False), (8, True)])
def test_builder_matches_jax(n, extras):
    kw = dict(seed=5, with_character=extras, with_trigger=extras)
    js, jst = jax_build_falling_boxes(n, **kw)
    ts, tst = build_falling_boxes(n, **kw, device="cpu")
    _assert_dicts_equal(_np(jst), convert.static_scene_to_numpy(tst))
    j, t = _np(js), convert.world_state_to_numpy(ts)
    np.testing.assert_allclose(t.pop("quat"), j.pop("quat"), atol=2.5e-7,
                               rtol=0)
    _assert_dicts_equal(j, t)   # positions and the rest: exact


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _unit_quats(rng, n):
    q = _rand(rng, n, 4)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


MATH_CASES = {
    "quat_normalize": lambda r: [_rand(r, 7, 4) * 3.0],
    "quat_mul": lambda r: [_unit_quats(r, 7), _unit_quats(r, 7)],
    "quat_rotate": lambda r: [_unit_quats(r, 7), _rand(r, 7, 3)],
    "quat_from_euler_xyz": lambda r: [_rand(r, 7, 3) * 2.0],
    "quat_to_mat3": lambda r: [_unit_quats(r, 7)],
    "quat_integrate": lambda r: [_unit_quats(r, 7), _rand(r, 7, 3),
                                 np.float32(1.0 / 120.0)],
    "mat_from_srt": lambda r: [np.abs(_rand(r, 7, 3)) + 0.5,
                                _unit_quats(r, 7), _rand(r, 7, 3)],
    "mat_mul": lambda r: [_rand(r, 7, 4, 4), _rand(r, 7, 4, 4)],
}


@pytest.mark.parametrize("name", sorted(MATH_CASES))
def test_math3d_matches_jax(name):
    args = MATH_CASES[name](np.random.default_rng(len(name)))
    want = np.asarray(getattr(jax_math3d, name)(*map(jnp.asarray, args)))
    got = getattr(math3d, name)(*map(torch.as_tensor, args)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _mixed_shapes(rng, n=24):
    shape_type = rng.integers(0, 3, n).astype(np.int8)   # none, box, capsule
    size = np.abs(_rand(rng, n, 3)) + 0.1
    return _rand(rng, n, 3) * 4.0, _unit_quats(rng, n), shape_type, size


def test_shapes_match_jax():
    pos, quat, shape_type, size = _mixed_shapes(np.random.default_rng(3))
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    for want, got in [
        (jax_shapes.shape_aabb(pos, quat, shape_type, size),
         shapes.shape_aabb(t(pos), t(quat), t(shape_type), t(size))),
        (jax_shapes.capsule_segment(pos, quat, size[:, 1]),
         shapes.capsule_segment(t(pos), t(quat), t(size[:, 1]))),
        ((jax_shapes.box_corners(pos, quat, size),),
         (shapes.box_corners(t(pos), t(quat), t(size)),)),
    ]:
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                       rtol=0)


def test_world_matrices_match_jax_on_a_hierarchy():
    rng = np.random.default_rng(4)
    n = 12
    # roots 0, 1, 2; children on three more levels; entity 7 dead
    parent = np.array([-1, -1, -1, 0, 0, 3, 4, 5, 1, 8, 9, 2], np.int32)
    alive = np.ones(n, bool)
    alive[7] = False
    levels = transform.compute_levels(parent, alive)
    np.testing.assert_array_equal(
        levels, jax_transform.compute_levels(parent, alive))
    assert levels.shape[0] == 4
    pos, quat = _rand(rng, n, 3), _unit_quats(rng, n)
    scale = np.abs(_rand(rng, n, 3)) + 0.5
    want = jax_transform.update_world_matrices(pos, quat, scale, parent,
                                               levels, alive)
    got = transform.update_world_matrices(
        *map(torch.as_tensor, (pos, quat, scale, parent, levels, alive)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_visual_positions_match_jax():
    js, jst = jax_build_falling_boxes(5, seed=1, with_character=True,
                                      with_trigger=True)
    want = np.asarray(jax_engine.visual_positions(js, jst))
    got = engine.visual_positions(
        convert.world_state_from_numpy(_np(js), "cpu"),
        convert.static_scene_from_numpy(_np(jst), "cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != np.asarray(js.pos)).any()   # the character moved


def test_triggers_match_jax():
    rng = np.random.default_rng(6)
    pos, quat, shape_type, size = _mixed_shapes(rng, 40)
    trig_entity = np.array([3, -1, 17], np.int32)
    trig_args = (trig_entity, np.array([1, 1, 2], np.int8),
                 np.abs(_rand(rng, 3, 3)) * 3.0 + 0.5,
                 np.array([4, 4, 1], np.uint32),
                 np.array([0xFFFFFFFF, 1, 0xFFFFFFFF], np.uint32),
                 np.array([True, True, True]))
    ent_args = (pos, quat, shape_type, size,
                rng.integers(1, 4, 40).astype(np.uint32),
                np.where(rng.random(40) < 0.5, 0xFFFFFFFF, 2).astype(
                    np.uint32),
                rng.random(40) < 0.9, rng.random(40) < 0.8)

    def to_torch(a):
        a = np.asarray(a)
        return torch.as_tensor(a.view(np.int32) if a.dtype == np.uint32
                               else a)

    want = np.asarray(jax_triggers.trigger_aabb_overlaps(*trig_args,
                                                         *ent_args))
    got = triggers.trigger_aabb_overlaps(*map(to_torch, trig_args),
                                         *map(to_torch, ent_args))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()

    prev = rng.random(want.shape) < 0.5
    one_shot = np.array([True, False, True])
    active = np.array([True, True, False])
    jax_out = jax_triggers.diff_events(prev, want, one_shot, active)
    torch_out = triggers.diff_events(*(torch.as_tensor(np.array(a)) for a in
                                       (prev, want, one_shot, active)))
    for w, g in zip(jax_out, torch_out):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _entry_points():
    """Every entry point that makes tensors, called without a device:
    (name, call) pairs."""
    from banggameengine_tpu_torch.render.camera import Camera
    from banggameengine_tpu_torch.render.shading import LightParams
    from banggameengine_tpu_torch.state import InputFrame, make_world_state

    inp = convert.input_frame_to_numpy(InputFrame.zero("cpu"))
    state, static = build_falling_boxes(4, device="cpu")
    return {
        "build_falling_boxes": lambda: build_falling_boxes(4)[0].pos,
        "make_world_state": lambda: make_world_state(4, 1).pos,
        "InputFrame.zero": lambda: InputFrame.zero().move_forward,
        "world_state_from_numpy": lambda: convert.world_state_from_numpy(
            convert.world_state_to_numpy(state)).pos,
        "static_scene_from_numpy": lambda: convert.static_scene_from_numpy(
            convert.static_scene_to_numpy(static)).mask,
        "input_frame_from_numpy": lambda: convert.input_frame_from_numpy(
            inp).cam_yaw,
        "render_scene_from_numpy": lambda: convert.render_scene_from_numpy(
            build_box_render(static)).tri_valid,
        "view_matrix": lambda: Camera().view_matrix(),
        "proj_matrix": lambda: Camera().proj_matrix(1.5),
        "mtx_proj": lambda: math3d.mtx_proj(60.0, 1.5, 0.1, 100.0),
        "LightParams.default": lambda: LightParams.default().ambient,
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_the_card(name):
    """With no device named, an entry point puts its tensors on the card;
    with no card it fails rather than fall back to the CPU."""
    call = _entry_points()[name]
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError),
                           match="CUDA|cuda"):
            call()
