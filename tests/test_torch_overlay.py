"""The port's overlays against the JAX package on the CPU: the line pass
(``render/lines.py``), the collision-shape lines (``physics/debugdraw.py``),
the F1 wireframe frame and the shades' edge mask
(``render/pipeline.py``, ``render/shading.py``), and the app's F3 and F1
frames against the JAX golden (``tests/data/overlay_jax_golden.npz``,
written by ``tests/test_torch_overlay_golden.py``).

Bars: the line pass's u8 frames exactly equal, on random segments over a
random frame and depth and on segments that share pixels, cross the near
plane, lie behind it or off screen; its sample parameters bit-equal to
``jnp.linspace``'s; the shape lines' points within 1e-6, colours and
``valid`` exact; the F1 frame exact; the shades' edge mask exact (the
cleared pixels equal) and the frame within 1 level; the app's F3 frame
within 1 level of JAX's on >= 99.9 % of pixels with every line pixel
exact, its F1 frame exact.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banggameengine_tpu.physics.debugdraw import (
    collision_shape_lines as jax_shape_lines,
)
from banggameengine_tpu.render.lines import draw_lines as jax_draw_lines
from banggameengine_tpu.render.pipeline import render_frame as jax_render_frame
from banggameengine_tpu.render.shading import LightParams as JaxLight
from banggameengine_tpu.render.shading import (
    shade_visibility as jax_shade_visibility,
)
from banggameengine_tpu.scene.build import RenderScene as JaxRenderScene
from banggameengine_tpu.state import StaticScene as JaxStatic
from banggameengine_tpu.state import WorldState as JaxState
from banggameengine_tpu_torch import convert, math3d
from banggameengine_tpu_torch.app.application import Application
from banggameengine_tpu_torch.physics.debugdraw import collision_shape_lines
from banggameengine_tpu_torch.render.lines import draw_lines, sample_params
from banggameengine_tpu_torch.render.pipeline import render_frame
from banggameengine_tpu_torch.render.shading import (
    CLEAR_COLOR,
    LightParams,
    shade_visibility,
)
from banggameengine_tpu_torch.scene.synthetic import (
    build_falling_boxes,
    build_showcase_render,
)
from banggameengine_tpu_torch.scripts.play_demo import apply_track
from test_torch_app_golden import ASSETS, FPS, SMALL
from test_torch_overlay_golden import FRAMES, GOLDEN_NPZ
from test_torch_render_frame import frame_agreement

W, H = 96, 64
EYE = (0.0, 3.0, -8.0)
NEAR = 0.1
L = 128                # segments a case (one shape: one JAX compile)


def _camera():
    view = math3d.mtx_look_at(torch.tensor(EYE), torch.zeros(3))
    proj = math3d.mtx_proj(60.0, W / H, NEAR, 100.0, device="cpu")
    return view, proj


def _segments(case: str, rng):
    """(points f32[L, 2, 3], colors f32[L, 4], valid bool[L]) of a case;
    the camera sits at EYE looking at the origin along +z."""
    if case == "random":
        pts = rng.uniform(-12, 12, (L, 2, 3))
    elif case == "same_pixel":
        # 64 copies of one segment and 64 of a 1 cm one: every sample of a
        # copy lands where the others' do
        long_seg = np.broadcast_to([[-2.0, 0.5, 1.0], [2.0, -0.5, 2.0]],
                                   (64, 2, 3))
        short = np.broadcast_to([[0.3, 0.2, 0.0], [0.31, 0.2, 0.0]],
                                (64, 2, 3))
        pts = np.concatenate([long_seg, short])
    elif case == "near_plane":
        # one end in front of the camera, one behind it (z < -8)
        a = rng.uniform([-3, -1, -2], [3, 3, 4], (L, 3))
        b = rng.uniform([-3, -1, -20], [3, 3, -8.5], (L, 3))
        pts = np.stack([a, b], axis=1)
    elif case == "behind":
        pts = rng.uniform([-5, -5, -30], [5, 5, -8.2], (L, 2, 3))
    elif case == "off_screen":
        side = rng.choice([-1.0, 1.0], (L, 1, 1))
        pts = rng.uniform([40, -3, 0], [80, 3, 10], (L, 2, 3))
        pts[..., 0:1] *= side
    else:
        raise ValueError(case)
    colors = rng.uniform(-0.2, 1.2, (L, 4))
    valid = rng.random(L) < 0.9 if case == "random" else np.ones(L, bool)
    return (pts.astype(np.float32), colors.astype(np.float32), valid)


def test_sample_params_equal_jnp_linspace():
    ref = np.asarray(jnp.linspace(0.0, 1.0, 128))
    got = sample_params("cpu").numpy()
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    # torch's own linspace rounds differently: the reason for the form
    assert not np.array_equal(torch.linspace(0, 1, 128).numpy(), ref)


@pytest.mark.parametrize("case", ["random", "same_pixel", "near_plane",
                                  "behind", "off_screen"])
def test_draw_lines_matches_jax(case):
    """u8 frames exactly equal: the winner of a shared pixel is the last
    passing sample, as in JAX's in-order scatter."""
    rng = np.random.default_rng(["random", "same_pixel", "near_plane",
                                 "behind", "off_screen"].index(case))
    pts, colors, valid = _segments(case, rng)
    frame = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
    depth = (rng.uniform(0.9, 1.0, (H, W)) if case == "random"
             else np.ones((H, W))).astype(np.float32)
    view, proj = _camera()
    ref = np.asarray(jax.jit(jax_draw_lines)(
        jnp.asarray(frame), jnp.asarray(depth), jnp.asarray(pts),
        jnp.asarray(colors), jnp.asarray(valid), jnp.asarray(view.numpy()),
        jnp.asarray(proj.numpy())))
    got = draw_lines(torch.as_tensor(frame), torch.as_tensor(depth),
                     torch.as_tensor(pts), torch.as_tensor(colors),
                     torch.as_tensor(valid), view, proj).numpy()
    assert got.dtype == np.uint8 and np.array_equal(got, ref)
    drawn = int((got != frame).any(-1).sum())
    if case in ("behind", "off_screen"):
        assert drawn == 0
    else:
        assert drawn > 0
    if case == "same_pixel":
        # the pixels of the long segment carry its last copy's colour
        last = (np.clip(colors[63], 0, 1) * 255).astype(np.uint8)
        assert (got == last).all(-1).sum() >= 0.5 * drawn


def _shape_scene():
    """Boxes (dynamic, one static, one kinematic), the character's capsule
    and the trigger of ``build_falling_boxes``, at random poses; one box
    dead."""
    state, static = build_falling_boxes(5, seed=2, with_character=True,
                                        with_trigger=True, device="cpu")
    rng = np.random.default_rng(5)
    n = state.capacity
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    state = dataclasses.replace(
        state, quat=torch.as_tensor(q),
        pos=torch.as_tensor(rng.uniform(-5, 5, (n, 3)).astype(np.float32)))
    static.body_type[1] = 1           # static
    static.body_type[2] = 3           # kinematic
    state.alive[3] = False            # dead
    return state, static


@pytest.mark.parametrize("trigger_active", [True, False])
def test_collision_shape_lines_match_jax(trigger_active):
    state, static = _shape_scene()
    state.trigger_active[:] = trigger_active
    js = JaxState(**{k: jnp.asarray(v) for k, v in
                     convert.world_state_to_numpy(state).items()})
    jst = JaxStatic(**{k: jnp.asarray(v) for k, v in
                       convert.static_scene_to_numpy(static).items()})
    ref = [np.asarray(a) for a in jax.jit(jax_shape_lines)(js, jst)]
    got = [a.numpy() for a in collision_shape_lines(state, static)]
    n, t = state.capacity, static.num_trigger_slots
    assert got[0].shape == ref[0].shape == (n * 28 + t * 12 + 22, 2, 3)
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-6)
    assert np.array_equal(got[1], ref[1]) and np.array_equal(got[2], ref[2])
    # the layout: a box's 12 edges, the capsule's 28, none of the dead box,
    # the trigger's 12 as it is active
    valid = got[2][:n * 28].reshape(n, 28)
    stype = static.shape_type.numpy()
    assert valid[0].sum() == 12 and not valid[3].any()
    assert valid[stype == 2].all()
    assert got[2][n * 28:n * 28 + 12].all() == trigger_active


def _showcase_args(width, height):
    sc = build_showcase_render(0)
    view = sc.camera.view_matrix("cpu")
    proj = sc.camera.proj_matrix(width / height, "cpu")
    return sc, view, proj


def test_wireframe_frame_matches_jax():
    """F1 exactly equal: the showcase's 4,194 mesh edges as lines over the
    clear colour; with ``depth_only`` the flag is ignored, as in JAX."""
    sc, view, proj = _showcase_args(W, H)
    rs = convert.render_scene_from_numpy(sc.render, "cpu")
    cam = torch.as_tensor(sc.camera.position)
    world = torch.as_tensor(sc.world)
    got, depth = render_frame(rs, world, view, proj, cam, width=W, height=H,
                              wireframe=True, return_depth=True)
    jrs = JaxRenderScene(**{k: jnp.asarray(v) for k, v in sc.render.items()})
    ref = np.asarray(jax.jit(functools.partial(
        jax_render_frame, width=W, height=H, wireframe=True))(
        jrs, jnp.asarray(sc.world), jnp.asarray(view.numpy()),
        jnp.asarray(proj.numpy()), jnp.asarray(sc.camera.position)))
    assert np.array_equal(got.numpy(), ref)
    assert bool((depth == 1).all())
    clear = tuple(int(c * 255) for c in CLEAR_COLOR) + (255,)
    assert (ref == clear).all(-1).any() and (ref == 255).all(-1).any()
    d_wire = render_frame(rs, world, view, proj, cam, width=W, height=H,
                          depth_only=True, wireframe=True)
    d_plain = render_frame(rs, world, view, proj, cam, width=W, height=H,
                           depth_only=True)
    assert torch.equal(d_wire, d_plain)


def test_shade_edge_mask_matches_jax():
    """The shades' ``wireframe`` flag (JAX's barycentric edge mask): on
    the same visibility planes, the same pixels keep their shade and the
    others take the clear colour; every channel within 1 level."""
    sc = build_showcase_render(0)
    r = sc.render
    t = r["tri_material"].shape[0]
    rng = np.random.default_rng(9)
    tri_id = rng.integers(-1, t, (H, W)).astype(np.int32)
    b1 = rng.uniform(0, 1, (H, W)).astype(np.float32)
    b2 = (rng.uniform(0, 1, (H, W)) * (1 - b1)).astype(np.float32)
    depth = rng.uniform(0.5, 0.99, (H, W)).astype(np.float32)
    view = sc.camera.view_matrix("cpu")
    proj = sc.camera.proj_matrix(W / H, "cpu")
    v = r["v_pos"].shape[0]
    world_nrm = np.tile(np.float32([[0.0, 1.0, 0.0]]), (v, 1))
    inv_w = rng.uniform(0.1, 1.0, v).astype(np.float32)
    cam = sc.camera.position
    tj = {k: jnp.asarray(x) for k, x in r.items()}
    frames = {}
    for wire in (False, True):
        ref = np.asarray(jax_shade_visibility(
            jnp.asarray(tri_id), jnp.asarray(b1), jnp.asarray(b2),
            jnp.asarray(r["v_pos"]), jnp.asarray(world_nrm), tj["v_uv"],
            jnp.asarray(inv_w), tj["tri_material"], tj["mat_base_tint"],
            tj["mat_uv_scale"], tj["mat_spec_params"], tj["mat_spec_color"],
            tj["mat_tex"], tj["textures"], tj["tex_size"], jnp.asarray(cam),
            JaxLight.default(), wireframe=wire,
            textures_quad=tj["textures_quad"],
            textures_quad_t=tj["textures_quad_t"], vis_depth=jnp.asarray(depth),
            view=jnp.asarray(view.numpy()), proj=jnp.asarray(proj.numpy())))
        tt = {k: torch.as_tensor(x) for k, x in r.items()}
        got = shade_visibility(
            torch.as_tensor(tri_id), torch.as_tensor(b1), torch.as_tensor(b2),
            torch.as_tensor(world_nrm), tt["v_uv"], torch.as_tensor(inv_w),
            tt["tri_material"], tt["mat_base_tint"], tt["mat_uv_scale"],
            tt["mat_spec_color"], tt["mat_tex"], tt["textures"],
            tt["tex_size"], tt["textures_quad_t"], torch.as_tensor(cam),
            LightParams.default("cpu"), torch.as_tensor(depth), view, proj,
            wireframe=wire).numpy()
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
        frames[wire] = got, ref
    b0 = 1.0 - b1 - b2
    off_edge = (np.minimum(np.minimum(b0, b1), b2) >= 0.05) & (tri_id >= 0)
    clear = np.array([int(c * 255 + 0.5) for c in CLEAR_COLOR], np.uint8)
    for img in frames[True]:
        assert (img[off_edge][:, :3] == clear).all()
    assert 0 < off_edge.sum() < off_edge.size
    # the edge pixels keep the shade of the plain frame
    edge = ~off_edge
    assert np.array_equal(frames[True][0][edge], frames[False][0][edge])


@pytest.fixture(scope="module")
def overlay_app():
    """The port's app through the golden's track on the CPU (128x32, the
    default path), then half a fixed step."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("BANG_ASSETS_DIR", raising=False)
        app = Application(assets_root=ASSETS, width=SMALL[0],
                          height=SMALL[1], device="cpu")
    cj = app.built.find_entity("cj")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for i in range(FRAMES):
            apply_track(app, i, FPS, cj)
            app.frame(real_dt=1.0 / FPS)
        app.frame(real_dt=0.5 * app.config.fixed_step)
    finally:
        torch.set_num_threads(n)
    return app


def test_app_overlay_frames_match_jax(overlay_app):
    """The app's F3 and F1 frames against the JAX app's: the inputs equal
    (the state exactly, on the CPU), F3 within 1 level on >= 99.9 % of
    pixels with every line pixel exact, F1 exact."""
    g = np.load(GOLDEN_NPZ)
    app = overlay_app
    got = convert.world_state_to_numpy(app.state)
    for k, v in got.items():
        assert np.array_equal(v, g["state_" + k]), k
    assert app._accumulator == float(g["accumulator"])
    base = app.render_current_frame()
    app.physics_overlay = True
    f3 = app.render_current_frame()
    app.physics_overlay = False
    app.wireframe = True
    f1 = app.render_current_frame()
    app.wireframe = False
    off, sky_off = frame_agreement(base, g["base_small"])
    assert off <= 0.001 * base.shape[0] * base.shape[1] and sky_off == 0
    off, _ = frame_agreement(f3, g["f3_small"])
    assert off <= 0.001 * f3.shape[0] * f3.shape[1]
    lines_ref = (g["f3_small"] != g["base_small"]).any(-1)
    lines_got = (f3 != base).any(-1)
    assert lines_ref.sum() > 0
    assert np.array_equal(lines_got, lines_ref)
    assert np.array_equal(f3[lines_ref], g["f3_small"][lines_ref])
    assert np.array_equal(f1, g["f1_small"])


def test_app_hud_lines_in_the_golden_moment(overlay_app):
    """The golden keeps the JAX HUD's lines of the same moment; the
    port's equal them but for the renderer's name."""
    from banggameengine_tpu_torch.app.hud import standard_hud_lines

    ref = [tuple(x) for x in json.loads(str(np.load(GOLDEN_NPZ)["hud_lines"]))]
    overlay_app.physics_overlay = True
    got = standard_hud_lines(overlay_app)
    overlay_app.physics_overlay = False
    assert len(got) == len(ref) == 10
    assert got[:1] + got[2:] == ref[:1] + ref[2:]
    assert got[1] == (0x0A, "Renderer: torch-cuda-raster")
