"""The port's interactive tick (engine step + shaded frame) against the JAX
package's, on a 32-box world, on the CPU.

The JAX tick runs ``make_frame_fn(built, ..., broadphase="pallas")``: its
broadphase kernel in interpret mode and its default XLA light/heavy
raster, which gives the walk's result wherever every tile that needs the
heavy pass ranks among its 64 fullest (all 10 tiles here).  The port runs
``broadphase="allpairs"`` and the walk, with the plain versions of its
kernels.  The state is held to the one-step tolerances of
``tests/test_torch_step.py``, the frame to those of
``tests/test_torch_render_frame.py``.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banggameengine_tpu.render.pipeline import make_frame_fn as jax_frame_fn
from banggameengine_tpu.scene.build import RenderScene as JaxRenderScene
from banggameengine_tpu.scene.synthetic import (
    build_falling_boxes as jax_build_falling_boxes,
)
from banggameengine_tpu.state import InputFrame as JaxInputFrame
from banggameengine_tpu_torch import convert
from banggameengine_tpu_torch.render.camera import Camera
from banggameengine_tpu_torch.render.pipeline import make_frame_fn
from banggameengine_tpu_torch.scene.build import BuiltScene
from banggameengine_tpu_torch.scene.synthetic import build_box_render
from banggameengine_tpu_torch.state import InputFrame
from test_torch_render_frame import SKY, frame_agreement
from test_torch_step import FLOAT_TOL

SCENE = dict(num_bodies=32, seed=11, spread=3.0)
W, H = 256, 160


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _camera():
    cam = Camera()
    cam.position[:] = (0.0, 9.0, -14.0)
    cam.set_yaw_pitch(np.pi / 2, -0.14)
    return (cam.view_matrix("cpu").numpy(),
            cam.proj_matrix(W / H, "cpu").numpy(),
            cam.position.copy())


def _port_built(state0, static0) -> BuiltScene:
    static = convert.static_scene_from_numpy(_np(static0), "cpu")
    return BuiltScene(static=static,
                      initial_state=convert.world_state_from_numpy(
                          _np(state0), "cpu"),
                      render=convert.render_scene_from_numpy(
                          build_box_render(static), "cpu"))


@pytest.fixture(scope="module")
def ticks():
    state0, static0 = jax_build_falling_boxes(**SCENE)
    built = _port_built(state0, static0)
    view, proj, cam_pos = _camera()
    jax_built = types.SimpleNamespace(
        static=static0,
        render=JaxRenderScene(**{
            k: jnp.asarray(v) for k, v in
            convert.render_scene_to_numpy(built.render).items()}))
    jtick = jax_frame_fn(jax_built, W, H, donate=False, broadphase="pallas")
    js, jimg, jev = jtick(state0, JaxInputFrame.zero(), jnp.asarray(view),
                          jnp.asarray(proj), jnp.asarray(cam_pos))
    tick = make_frame_fn(built, W, H, broadphase="allpairs")
    ts, timg, tev = tick(built.initial_state, InputFrame.zero("cpu"),
                         torch.as_tensor(view), torch.as_tensor(proj),
                         torch.as_tensor(cam_pos))
    return ((_np(js), np.array(jimg), int(jev.contact_overflow)),
            (convert.world_state_to_numpy(ts), timg.numpy(),
             int(tev.contact_overflow)))


def test_tick_state_matches_jax(ticks):
    (js, _, jo), (ts, _, to) = ticks
    assert jo == to
    for name, a in js.items():
        b = ts[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype.kind == "f":
            atol, rtol = FLOAT_TOL.get(name, (1e-5, 0.0))
            np.testing.assert_allclose(b, a, atol=atol, rtol=rtol,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


def test_tick_frame_matches_jax(ticks):
    (_, jimg, _), (_, timg, _) = ticks
    assert timg.dtype == np.uint8 and timg.shape == (H, W, 4)
    off, sky_off = frame_agreement(timg, jimg)
    assert off <= 0.001 * H * W, f"{off} pixels differ by more than 1 level"
    assert sky_off == 0, f"sky mask differs at {sky_off} other pixels"
    assert 0.05 < (timg != SKY).any(-1).mean() < 0.95   # boxes in view


def test_box_render_scene():
    state0, static0 = jax_build_falling_boxes(**SCENE)
    render = build_box_render(_port_built(state0, static0).static)
    n = SCENE["num_bodies"]
    assert int(render["tri_valid"].sum()) == 12 * n
    np.testing.assert_array_equal(render["v_entity"][:36 * n],
                                  np.repeat(np.arange(n), 36))
    np.testing.assert_allclose(render["ent_aabb_max"][:n], 0.5)
    assert render["ent_has_mesh"][:n].all()


def test_substeps_stack_events_and_update_static():
    state0, static0 = jax_build_falling_boxes(8, seed=2, spread=2.0)
    built = _port_built(state0, static0)
    view, proj, cam_pos = (torch.as_tensor(a) for a in _camera())
    inp = InputFrame.zero("cpu")
    one = make_frame_fn(built, 64, 32, broadphase="allpairs")
    two = make_frame_fn(built, 64, 32, substeps=2, broadphase="allpairs")
    s0, _, _ = one(built.initial_state, inp, view, proj, cam_pos)
    s1, img1, _ = one(s0, inp, view, proj, cam_pos)
    s2, img2, ev2 = two(built.initial_state, inp, view, proj, cam_pos)
    assert torch.equal(s1.pos, s2.pos) and torch.equal(img1, img2)
    assert ev2.contact_overflow.shape == (2,)
    assert ev2.trigger_enter.shape[0] == 2
    frozen = dataclasses.replace(built.static,
                                 gravity=torch.zeros((), dtype=torch.float32))
    one.update_static(frozen)
    s3, _, _ = one(built.initial_state, inp, view, proj, cam_pos)
    ref = make_frame_fn(dataclasses.replace(built, static=frozen), 64, 32,
                        broadphase="allpairs")
    s4, _, _ = ref(built.initial_state, inp, view, proj, cam_pos)
    assert torch.equal(s3.pos, s4.pos)
    assert not torch.equal(s3.pos, s0.pos)


def test_pipelined_tick_matches_jax():
    """``pipelined=True`` renders the world of the state passed in, then
    steps: the frame is the pre-step world's, the state the same step's,
    each against the JAX package's pipelined tick."""
    state0, static0 = jax_build_falling_boxes(8, seed=2, spread=2.0)
    built = _port_built(state0, static0)
    view, proj, cam_pos = _camera()
    jax_built = types.SimpleNamespace(
        static=static0,
        render=JaxRenderScene(**{
            k: jnp.asarray(v) for k, v in
            convert.render_scene_to_numpy(built.render).items()}))
    jtick = jax_frame_fn(jax_built, 64, 32, donate=False, pipelined=True,
                         broadphase="pallas")
    js, jimg, _ = jtick(state0, JaxInputFrame.zero(), jnp.asarray(view),
                        jnp.asarray(proj), jnp.asarray(cam_pos))
    t = torch.as_tensor
    tick = make_frame_fn(built, 64, 32, pipelined=True,
                         broadphase="allpairs")
    ts, timg, _ = tick(built.initial_state, InputFrame.zero("cpu"), t(view),
                       t(proj), t(cam_pos))
    ref = make_frame_fn(built, 64, 32, broadphase="allpairs")
    s_ref, _, _ = ref(built.initial_state, InputFrame.zero("cpu"), t(view),
                      t(proj), t(cam_pos))
    assert torch.equal(ts.pos, s_ref.pos)
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos),
                               atol=FLOAT_TOL.get("pos", (1e-5, 0))[0])
    off, sky_off = frame_agreement(timg.numpy(), np.array(jimg))
    assert off <= 0.001 * 64 * 32 and sky_off == 0
    from banggameengine_tpu_torch.render.pipeline import make_render_fn

    pre = make_render_fn(built.render, 64, 32, bin_capacity=2048)(
        built.initial_state.world, t(view), t(proj), t(cam_pos))
    assert torch.equal(timg, pre)


@pytest.mark.parametrize("flag", ["merged", "merged_barrier"])
def test_merged_ticks_equal_the_default_order(flag):
    """Eager PyTorch has one order, step then frame: the JAX package's
    single-program ticks give the default tick bit for bit."""
    state0, static0 = jax_build_falling_boxes(8, seed=2, spread=2.0)
    built = _port_built(state0, static0)
    view, proj, cam_pos = (torch.as_tensor(a) for a in _camera())
    inp = InputFrame.zero("cpu")
    outs = [make_frame_fn(built, 64, 32, substeps=2, broadphase="allpairs",
                          **kw)(built.initial_state, inp, view, proj,
                                cam_pos)
            for kw in ({}, {flag: True})]
    (s0, img0, ev0), (s1, img1, ev1) = outs
    for f in dataclasses.fields(s0):
        assert torch.equal(getattr(s0, f.name), getattr(s1, f.name)), f.name
    assert torch.equal(img0, img1)
    assert torch.equal(ev0.trigger_enter, ev1.trigger_enter)
