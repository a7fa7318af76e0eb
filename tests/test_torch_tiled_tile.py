"""The tiled shade over the light/heavy full-carry raster
(``render_frame(shade_mode="tiled", raster_backend="tile")``) against the
JAX package's tiled shade over its light/heavy scan, its row-gather
fallback, and the two bilinear texture samplers.

The frame: the showcase (:func:`build_showcase_render`, numpy, the same
arrays on both sides) at 256x160, against
``tests/data/tiled_tile_jax_golden.npz``: JAX's ``make_render_fn(...,
raster_backend="xla")`` on the CPU, its light/heavy tile scan (the
planes the port's ``"tile"`` kernel computes) and its one-hot resolve.
Bar: within 1 level on >= 99.9 % of pixels, the sky mask equal elsewhere
(the port's frame bar: JAX's CPU compiler fuses multiply-adds, PyTorch
does not).  ``PYTHONPATH=. JAX_PLATFORMS=cpu python
tests/test_torch_tiled_tile.py`` rewrites the golden, after checking that
JAX's ``"pallas_interpret"`` raster gives the same frame.

The fallback: ``shade_visibility_tiled`` with ``shade_slots=64`` (the
light pass's width) and ``heavy_shade_slots=80``, narrower than the heavy
pass's 272, so the heavy tiles' winners beyond slot 80 take the row
gather; JAX's shade with the same arguments, the same bar, and some
pixels must take it.

``make_frame_fn`` and ``make_interp_render_fn`` take the same route
(``raster_backend="tile"``) as ``render_frame``, bit for bit.

The samplers: ``tests/test_render.py:175``'s 2x2 case, and random uvs
outside [0, 1] over pages of three sizes padded into one square; each
channel within 1e-6.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banggameengine_tpu import math3d as jax_math3d
from banggameengine_tpu.render import raster as jax_rz
from banggameengine_tpu.render import shading as jax_shading
from banggameengine_tpu.render.cull import entity_frustum_mask
from banggameengine_tpu.render.pipeline import make_render_fn as jax_render_fn
from banggameengine_tpu.scene.build import RenderScene as JaxRenderScene
from banggameengine_tpu_torch import convert, math3d
from banggameengine_tpu_torch.render import raster as rz
from banggameengine_tpu_torch.render import shading
from banggameengine_tpu_torch.render.cull import (
    entity_frustum_mask as port_frustum_mask,
)
from banggameengine_tpu_torch.render.pipeline import render_frame
from banggameengine_tpu_torch.scene.build import _texture_pages
from banggameengine_tpu_torch.scene.synthetic import build_showcase_render

from test_torch_app_golden import one_torch_thread  # noqa: F401
from test_torch_render_frame import _camera_arrays, frame_agreement

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "tiled_tile_jax_golden.npz")
SEED, W, H = 0, 256, 160
OFF_SHARE = 1e-3
NARROW = dict(shade_slots=64, heavy_shade_slots=80)
SAMPLER_ATOL = 1e-6


def _jax_scene(sc):
    return JaxRenderScene(**{k: jnp.asarray(v) for k, v in sc.render.items()})


def _jax_frame(sc, cam, raster_backend):
    fn = jax_render_fn(_jax_scene(sc), W, H, raster_backend=raster_backend)
    return np.array(fn(jnp.asarray(sc.world), jnp.asarray(cam["view"]),
                       jnp.asarray(cam["proj"]), jnp.asarray(cam["cam_pos"])))


def _golden() -> dict:
    sc = build_showcase_render(SEED)
    cam = _camera_arrays(sc)
    return dict(frame=_jax_frame(sc, cam, "xla"), seed=np.int32(SEED),
                width=np.int32(W), height=np.int32(H), **cam)


@pytest.fixture(scope="module")
def scene():
    sc = build_showcase_render(SEED)
    cam = _camera_arrays(sc)
    return sc, cam, {k: torch.as_tensor(v) for k, v in cam.items()}


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return dict(z)


def test_frame_matches_the_jax_golden(scene, golden, one_torch_thread):
    sc, _, cam = scene
    rs = convert.render_scene_from_numpy(sc.render, "cpu")
    frame = render_frame(rs, torch.as_tensor(sc.world), cam["view"],
                         cam["proj"], cam["cam_pos"], width=W, height=H,
                         shade_mode="tiled", raster_backend="tile").numpy()
    assert frame.dtype == np.uint8 and frame.shape == (H, W, 4)
    off, sky_off = frame_agreement(frame, golden["frame"])
    assert off <= OFF_SHARE * H * W, f"{off} pixels differ by > 1 level"
    assert sky_off == 0, f"sky mask differs at {sky_off} other pixels"
    # the route's fallback is statically dead: it equals the flat frame's
    # shade of the same planes
    flat = render_frame(rs, torch.as_tensor(sc.world), cam["view"],
                        cam["proj"], cam["cam_pos"], width=W, height=H,
                        shade_mode="flat", raster_backend="tile").numpy()
    assert frame_agreement(frame, flat) == (0, 0)


def _port_tiled(sc, cam):
    """The port's frame front (cull, transform, the tile raster) and the
    shade's arguments, as ``render_frame`` makes them."""
    rs = convert.render_scene_from_numpy(sc.render, "cpu")
    world = torch.as_tensor(sc.world)
    vis_ent = port_frustum_mask(rs.ent_aabb_min, rs.ent_aabb_max,
                                rs.ent_has_mesh, world, cam["view"],
                                cam["proj"])
    tri_valid = rs.tri_valid & vis_ent[rs.v_entity[::3].long()]
    _, clip = rz.transform_vertices(rs.v_pos, rs.v_entity, world,
                                    cam["view"], cam["proj"])
    _, _, tiled = rz.rasterize(clip, tri_valid, W, H, bin_capacity=512,
                               return_tiled=True, backend="tile")
    nrm = rz.transform_normals(rs.v_nrm, rs.v_entity,
                               math3d.normal_matrix(world))
    w = clip[:, 3]
    inv_w = 1.0 / torch.where(w.abs() > 1e-9, w, 1e-9)
    args = (W, H, nrm, rs.v_uv, inv_w, rs.tri_material, rs.mat_base_tint,
            rs.mat_uv_scale, rs.mat_spec_color, rs.mat_tex, rs.textures,
            rs.tex_size, rs.textures_quad_t, cam["cam_pos"],
            shading.LightParams.default("cpu"), cam["view"], cam["proj"])
    return tiled, args


def _jax_tiled_frame(sc, cam, **kw):
    fn = jax.jit(functools.partial(_jax_tiled_shade, **kw))
    return np.array(fn(_jax_scene(sc), jnp.asarray(sc.world),
                       jnp.asarray(cam["view"]), jnp.asarray(cam["proj"]),
                       jnp.asarray(cam["cam_pos"])))


def _jax_tiled_shade(rs, world, view, proj, cam_pos, **kw):
    vis_ent = entity_frustum_mask(rs.ent_aabb_min, rs.ent_aabb_max,
                                  rs.ent_has_mesh, world, view, proj)
    tri_valid = rs.tri_valid & vis_ent[rs.v_entity[::3]]
    world_pos, clip = jax_rz.transform_vertices(rs.v_pos, rs.v_entity,
                                                world, view, proj)
    _, _, tiled = jax_rz.rasterize(clip, tri_valid, W, H, bin_capacity=512,
                                   return_tiled=True, backend="xla",
                                   slim=True)
    nrm = jax_rz.transform_normals(rs.v_nrm, rs.v_entity,
                                   jax_math3d.normal_matrix(world))
    inv_w = 1.0 / jnp.where(jnp.abs(clip[:, 3]) > 1e-9, clip[:, 3], 1e-9)
    return jax_shading.shade_visibility_tiled(
        tiled, W, H, world_pos, nrm, rs.v_uv, inv_w, rs.tri_material,
        rs.mat_base_tint, rs.mat_uv_scale, rs.mat_spec_params,
        rs.mat_spec_color, rs.mat_tex, rs.textures, rs.tex_size,
        cam_pos, jax_shading.LightParams.default(), view, proj,
        textures_quad=rs.textures_quad, textures_quad_t=rs.textures_quad_t,
        resolve_backend="xla", **kw)


def test_narrow_shade_takes_the_fallback_as_jax(scene, one_torch_thread):
    sc, cam_np, cam = scene
    tiled, args = _port_tiled(sc, cam)
    covered = shading.tiled_resolve_width(tiled, **NARROW)
    assert covered == NARROW["heavy_shade_slots"] < tiled.ids.shape[1]
    n_fb = int((tiled.slot >= covered).sum())
    assert n_fb > 0, "no winner beyond the resolved width"
    frame = shading.shade_visibility_tiled(tiled, *args, **NARROW).numpy()
    ref = _jax_tiled_frame(sc, cam_np, **NARROW)
    off, sky_off = frame_agreement(frame, ref)
    assert off <= OFF_SHARE * H * W, f"{off} pixels differ by > 1 level"
    assert sky_off == 0
    # the fallback carries those pixels: the resolve alone leaves them
    # with zero rows (black, alpha 0 after the shade)
    wide = shading.shade_visibility_tiled(
        tiled, *args, shade_slots=64,
        heavy_shade_slots=rz.K_GLOBAL + rz.HEAVY_CAPACITY).numpy()
    assert np.array_equal(frame, wide)
    dead = shading.shade_visibility_tiled(tiled, *args, **NARROW,
                                          raster_max_slots=covered).numpy()
    assert not np.array_equal(dead, frame)


def test_factories_take_the_tile_raster(one_torch_thread):
    """``make_frame_fn`` and ``make_interp_render_fn`` render through the
    tiled shade over the tile raster as ``render_frame`` does."""
    from banggameengine_tpu_torch.engine import engine_step
    from banggameengine_tpu_torch.render.camera import Camera
    from banggameengine_tpu_torch.render.pipeline import (
        make_frame_fn, make_interp_render_fn)
    from banggameengine_tpu_torch.scene.build import BuiltScene
    from banggameengine_tpu_torch.scene.synthetic import (
        build_box_render, build_falling_boxes)
    from banggameengine_tpu_torch.state import InputFrame

    state, static = build_falling_boxes(16, seed=2, spread=2.0,
                                        device="cpu")
    built = BuiltScene(static=static, initial_state=state,
                       render=convert.render_scene_from_numpy(
                           build_box_render(static), "cpu"))
    cam = Camera()
    cam.position[:] = (0.0, 9.0, -14.0)
    cam.set_yaw_pitch(np.pi / 2, -0.3)
    mats = (cam.view_matrix("cpu"), cam.proj_matrix(W / H, "cpu"),
            torch.as_tensor(cam.position))
    inp = InputFrame.zero("cpu")
    tick = make_frame_fn(built, W, H, raster_backend="tile")
    s1, img, _ = tick(state, inp, *mats)
    want_state, _ = engine_step(state, inp, static)
    want = render_frame(built.render, want_state.world, *mats, width=W,
                        height=H, bin_capacity=2048, shade_mode="tiled",
                        raster_backend="tile")
    assert torch.equal(s1.pos, want_state.pos) and torch.equal(img, want)
    interp = make_interp_render_fn(built.render, W, H,
                                   raster_backend="tile")
    assert torch.equal(interp(state, s1, 1.0, static, *mats),
                       render_frame(built.render, s1.world, *mats, width=W,
                                    height=H, shade_mode="tiled",
                                    raster_backend="tile"))
    assert bool((img != torch.tensor((0x88, 0xAA, 0xFF, 0xFF),
                                     dtype=torch.uint8)).any())


def _sampler_pair(textures, tex_size, tex_id, uv, quad):
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    j = jnp.asarray
    out = []
    if quad is None:
        out.append(shading.sample_texture_bilinear(
            t(textures), t(tex_size), t(tex_id), t(uv)).numpy())
        out.append(np.asarray(jax_shading.sample_texture_bilinear(
            j(textures), j(tex_size), j(tex_id), j(uv))))
    else:
        out.append(shading.sample_texture_bilinear_quad(
            t(quad), t(tex_size), t(tex_id), t(uv)).numpy())
        out.append(np.asarray(jax_shading.sample_texture_bilinear_quad(
            j(quad), j(tex_size), j(tex_id), j(uv))))
    return out


def test_samplers_match_jax():
    # tests/test_render.py:175: texel centres of a 2x2 checker
    tex = np.zeros((1, 2, 2, 4), np.uint8)
    tex[0, 0, 0] = [255, 0, 0, 255]
    tex[0, 0, 1] = [0, 255, 0, 255]
    tex[0, 1, 0] = [0, 0, 255, 255]
    tex[0, 1, 1] = [255, 255, 255, 255]
    size = np.int32([[2, 2]])
    uv = np.float32([[0.25, 0.25], [0.75, 0.25], [0.25, 0.75]])
    port, ref = _sampler_pair(tex, size, np.zeros(3, np.int32), uv, None)
    np.testing.assert_allclose(port, ref, atol=SAMPLER_ATOL, rtol=0)
    np.testing.assert_allclose(port[:, :3], [[1, 0, 0], [0, 1, 0],
                                             [0, 0, 1]], atol=1e-5)
    # random pages of three sizes, random uvs well outside [0, 1]
    rng = np.random.default_rng(3)
    pages = [rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
             for h, w in ((8, 8), (3, 5), (16, 2))]
    textures, tex_size, quads = _texture_pages(pages)
    n = 4096
    tex_id = rng.integers(0, 3, n).astype(np.int32)
    uv = rng.uniform(-3.0, 4.0, (n, 2)).astype(np.float32)
    uv[:8] = np.float32([[0, 0], [1, 1], [-1, 2], [0.5, -0.5], [2.0, 0.0],
                         [-0.0625, 1.0625], [1e-7, -1e-7], [3.5, -2.5]])
    for quad in (None, quads):
        port, ref = _sampler_pair(textures, tex_size, tex_id, uv, quad)
        assert port.shape == (n, 4) and port.dtype == np.float32
        np.testing.assert_allclose(port, ref, atol=SAMPLER_ATOL, rtol=0)
    # the one-fetch pack gives the four-fetch sampler's colours
    four, _ = _sampler_pair(textures, tex_size, tex_id, uv, None)
    one, _ = _sampler_pair(textures, tex_size, tex_id, uv, quads)
    np.testing.assert_allclose(one, four, atol=SAMPLER_ATOL, rtol=0)


def test_chip_smoke_golden_is_current(golden):
    fresh = _golden()
    assert sorted(fresh) == sorted(golden)
    for k, v in fresh.items():
        assert np.array_equal(golden[k], v), (
            f"tests/data/tiled_tile_jax_golden.npz is stale in {k}: run "
            "PYTHONPATH=. JAX_PLATFORMS=cpu python "
            "tests/test_torch_tiled_tile.py")


if __name__ == "__main__":
    g = _golden()
    sc = build_showcase_render(SEED)
    interp = _jax_frame(sc, _camera_arrays(sc), "pallas_interpret")
    off, sky_off = frame_agreement(interp, g["frame"])
    assert (off, sky_off) == (0, 0), (off, sky_off)
    np.savez_compressed(GOLDEN, **g)
    print(f"wrote {GOLDEN}; the pallas_interpret raster's frame differs at "
          f"{int((interp != g['frame']).any(-1).sum())} pixels")
