"""The frame factories as captured programs, on the CPU through the graph
stand-in of ``test_torch_graphs.py``, against the same factories run
eagerly (bit-equal) and the JAX package's jitted ones (the frame within
1 level on >= 99.9 % of pixels and the sky mask equal elsewhere, the
state within ``test_torch_dense_step``'s bar, 1e-4), on the 32-box
world at 64x48:

- the interpolated frame (``make_interp_render_fn``) at two ``alpha``s
  through one capture: ``alpha`` is copied into the graph each call (a
  float or a 0-d tensor), so the second frame is not the first's;
- the tick (``make_frame_fn``) in its default form (a step graph, then a
  frame graph), ``merged=True`` (one graph) and ``pipelined=True``, with
  ``update_static`` between two ticks: a scene of the same shapes is
  copied into the captured one (no new capture) and the next tick falls
  by it.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banggameengine_tpu.render.pipeline import make_frame_fn as jax_frame_fn
from banggameengine_tpu.render.pipeline import (
    make_interp_render_fn as jax_interp_fn,
)
from banggameengine_tpu.scene.build import RenderScene as JaxRenderScene
from banggameengine_tpu.scene.synthetic import (
    build_falling_boxes as jax_build_falling_boxes,
)
from banggameengine_tpu.state import InputFrame as JaxInputFrame
from banggameengine_tpu.state import WorldState as JaxWorldState
from banggameengine_tpu_torch import convert, graphs
from banggameengine_tpu_torch.engine import make_multi_step_fn
from banggameengine_tpu_torch.render.camera import Camera
from banggameengine_tpu_torch.render.pipeline import (
    make_frame_fn,
    make_interp_render_fn,
)
from banggameengine_tpu_torch.scene.build import BuiltScene
from banggameengine_tpu_torch.scene.synthetic import build_box_render
from banggameengine_tpu_torch.state import InputFrame
from test_torch_graphs import (  # noqa: F401
    assert_bit_equal,
    assert_close_to_jax,
    captured,
)
from test_torch_render_frame import frame_agreement

SCENE = dict(num_bodies=32, seed=11, spread=3.0)
W, H = 64, 48


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _camera():
    cam = Camera()
    cam.position[:] = (0.0, 9.0, -14.0)
    cam.set_yaw_pitch(np.pi / 2, -0.14)
    return (cam.view_matrix("cpu"), cam.proj_matrix(W / H, "cpu"),
            torch.as_tensor(cam.position))


def _built(state0, static0) -> BuiltScene:
    static = convert.static_scene_from_numpy(_np(static0), "cpu")
    return BuiltScene(static=static,
                      initial_state=convert.world_state_from_numpy(
                          _np(state0), "cpu"),
                      render=convert.render_scene_from_numpy(
                          build_box_render(static), "cpu"))


def _jax_render(built):
    return JaxRenderScene(**{
        k: jnp.asarray(v)
        for k, v in convert.render_scene_to_numpy(built.render).items()})


def _agree(got: np.ndarray, want) -> None:
    off, sky_off = frame_agreement(got, np.asarray(want))
    assert off <= 0.001 * H * W and sky_off == 0, (off, sky_off)


def test_interpolated_frame_at_two_alphas(captured):
    js0, jst = jax_build_falling_boxes(**SCENE)
    built = _built(js0, jst)
    with graphs.eager():
        later = make_multi_step_fn(built.static, 30)(
            built.initial_state, InputFrame.zero("cpu"))
    prev = built.initial_state
    view, proj, cam = _camera()
    render = make_interp_render_fn(built.render, W, H, return_depth=True)
    args = (built.static, view, proj, cam)
    alphas = (0.25, torch.tensor(0.75))
    got = [render(prev, later, a, *args) for a in alphas]
    assert render.program.captures == 1
    with graphs.eager():
        want = [render(prev, later, a, *args) for a in alphas]
    assert_bit_equal(got, want, "interpolated frames")
    assert not torch.equal(got[0][0], got[1][0])     # alpha not frozen
    jrender = jax_interp_fn(_jax_render(built), W, H, return_depth=True)
    jprev, jlater = (JaxWorldState(**{
        k: jnp.asarray(v)
        for k, v in convert.world_state_to_numpy(s).items()})
        for s in (prev, later))
    for (frame, depth), a in zip(got, (0.25, 0.75)):
        jframe, jdepth = jrender(jprev, jlater, a, jst, jnp.asarray(view),
                                 jnp.asarray(proj), jnp.asarray(cam))
        _agree(frame.numpy(), jframe)
        np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth),
                                   atol=1e-6, rtol=0)


def _ticks(fn, built, view, proj, cam, heavier):
    """Two ticks, ``update_static(heavier)`` between them; copies of the
    outputs (a donated tick's state and events are its buffers)."""
    inp = InputFrame.zero("cpu")
    out = [graphs.clone_tree(fn(built.initial_state, inp, view, proj,
                                cam))]
    fn.update_static(heavier)
    out.append(graphs.clone_tree(fn(out[0][0], inp, view, proj, cam)))
    return out


@pytest.mark.parametrize("form", ["default", "merged", "pipelined"])
def test_tick_forms_and_update_static(captured, form):
    js0, jst = jax_build_falling_boxes(**SCENE)
    view, proj, cam = _camera()
    kw = {"default": {}, "merged": dict(merged=True),
          "pipelined": dict(pipelined=True)}[form]
    runs = []
    for route in ("graph", "eager"):
        built = _built(js0, jst)
        heavier = dataclasses.replace(built.static,
                                      gravity=built.static.gravity * 3.0)
        tick = make_frame_fn(built, W, H, **kw)
        if route == "eager":
            with graphs.eager():
                runs.append(_ticks(tick, built, view, proj, cam, heavier))
        else:
            runs.append(_ticks(tick, built, view, proj, cam, heavier))
            assert [p.captures for p in tick.programs] == (
                [0, 0, 1] if form == "merged" else [1, 1, 0])
            assert float(built.static.gravity) == float(heavier.gravity)
    assert_bit_equal(runs[0], runs[1], f"{form} ticks")
    if form != "default":
        return
    built = _built(js0, jst)
    jtick = jax_frame_fn(types.SimpleNamespace(
        static=jst, render=_jax_render(built)), W, H, donate=False)
    jargs = (JaxInputFrame.zero(), jnp.asarray(view), jnp.asarray(proj),
             jnp.asarray(cam))
    j1 = jtick(js0, *jargs)
    jtick.update_static(dataclasses.replace(jst, gravity=jst.gravity * 3.0))
    j2 = jtick(j1[0], *jargs)
    for (ts, timg, _), (js, jimg, _) in zip(runs[0], (j1, j2)):
        assert_close_to_jax(ts, js)
        _agree(timg.numpy(), jimg)
