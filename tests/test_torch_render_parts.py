"""The port's renderer, part by part, against the JAX package on the CPU.

Every part gets the same numpy inputs on both sides.  The Pallas kernels of
the JAX package run in interpret mode, as its own CPU tests run them; the
port runs the plain versions of its CUDA kernels, which is what a CPU
tensor gets.

Tolerances: exact for integer and selection outputs (cull mask, bin ids,
counts, overflow, packed rows, the resolve); floats of the transforms,
near clip and setup rtol 1e-6, atol 1e-4 (JAX's CPU compiler fuses
multiply-adds, PyTorch's eager ops round every step); the walk's slots
equal on >= 99.99 % of pixels (a pixel exactly on an edge may flip) and
its depth within 1e-6 where the slots agree.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banggameengine_tpu import math3d as jm
from banggameengine_tpu.render import raster as jrz
from banggameengine_tpu.render.camera import Camera as JaxCamera
from banggameengine_tpu.render.cull import entity_frustum_mask as jax_cull
from banggameengine_tpu.render.raster_resolve_pallas import (
    pack_tile_triangles as jax_pack,
    raster_walk_pallas,
)
from banggameengine_tpu.render.resolve_pallas import resolve_tiles_pallas_wide
from banggameengine_tpu.scene import ResourceManager, build_scene
from banggameengine_tpu.scene import parse_scene_json
from banggameengine_tpu_torch import convert, kernel_cases, math3d
from banggameengine_tpu_torch.render import raster as rz
from banggameengine_tpu_torch.render.camera import Camera
from banggameengine_tpu_torch.render.cull import entity_frustum_mask
from banggameengine_tpu_torch.render.raster_walk import (
    PACK_CH,
    cover_boxes,
    pixel_centres,
    raster_walk,
    raster_walk_reference,
    slot_coverage,
)
from banggameengine_tpu_torch.render.resolve import (
    resolve_tiles_wide,
    resolve_tiles_wide_reference,
)
from banggameengine_tpu_torch.render.shading import (
    LightParams,
    shade_visibility_tiled,
)
from banggameengine_tpu_torch.scene.build import pack_render_scene
from banggameengine_tpu_torch.scene.synthetic import build_showcase_render

W, H = 256, 160
F_TOL = dict(rtol=1e-6, atol=1e-4)


# the JAX side runs jitted: one compile per function instead of one per op
_jax_bin = jax.jit(jrz.bin_triangles, static_argnums=(1, 2),
                   static_argnames=("k_local",))
_jax_pack = jax.jit(jax_pack)
_jax_rasterize = jax.jit(jrz.rasterize, static_argnums=(2, 3),
                         static_argnames=("bin_capacity", "backend", "slim"))


@functools.cache
def _showcase():
    return build_showcase_render(0)


@pytest.fixture(scope="module")
def showcase():
    return _showcase()


def _camera_mats(camera, width, height):
    return (camera.view_matrix("cpu").numpy(),
            camera.proj_matrix(width / height, "cpu").numpy())


@functools.partial(jax.jit, static_argnums=(4, 5))
def _jax_front(r, world, view, proj, width, height):
    vis = jax_cull(r["ent_aabb_min"], r["ent_aabb_max"], r["ent_has_mesh"],
                   world, view, proj)
    tri_valid = r["tri_valid"] & vis[r["v_entity"][::3]]
    _, clip = jrz.transform_vertices(r["v_pos"], r["v_entity"], world, view,
                                     proj)
    t = clip.shape[0] // 3
    sub = jrz.clip_near_plane(clip.reshape(t, 3, 4), tri_valid)
    tri = jrz.setup_triangles(sub[0].reshape(2 * t, 3, 4),
                              sub[2].reshape(2 * t), width, height)
    return clip, tri_valid, sub, tri


@functools.cache
def _setup(width, height):
    """The JAX package's clip, near clip and setup of the showcase scene,
    as numpy: (clip, tri_valid, (sub_clip, sub_bary, sub_valid), tri)."""
    sc = _showcase()
    view, proj = _camera_mats(sc.camera, width, height)
    keys = ("ent_aabb_min", "ent_aabb_max", "ent_has_mesh", "tri_valid",
            "v_entity", "v_pos")
    out = _jax_front({k: sc.render[k] for k in keys}, sc.world, view, proj,
                     width, height)
    return jax.tree.map(np.array, out)


def _torch_tri(tri):
    return {k: (tuple(torch.as_tensor(b) for b in v) if isinstance(v, tuple)
                else torch.as_tensor(v)) for k, v in tri.items()}


def test_camera_matrices(showcase):
    jc = JaxCamera()
    jc.position[:] = showcase.camera.position
    jc.set_yaw_pitch(showcase.camera.yaw, showcase.camera.pitch)
    np.testing.assert_allclose(showcase.camera.view_matrix("cpu").numpy(),
                               np.asarray(jc.view_matrix()), atol=1e-6)
    np.testing.assert_allclose(
        showcase.camera.proj_matrix(16 / 9, "cpu").numpy(),
        np.asarray(jc.proj_matrix(16 / 9)), atol=1e-6, rtol=1e-6)
    angles = np.linspace(-1.5, 1.5, 7, dtype=np.float32)
    np.testing.assert_allclose(
        math3d.yaw_pitch_forward(torch.as_tensor(angles),
                                 torch.as_tensor(angles[::-1].copy())),
        np.asarray(jm.yaw_pitch_forward(angles, angles[::-1])), atol=1e-6)
    mats = showcase.world[:4]
    np.testing.assert_allclose(math3d.normal_matrix(torch.as_tensor(mats)),
                               np.asarray(jm.normal_matrix(mats)), atol=1e-6,
                               rtol=1e-5)
    cam = Camera()
    cam.move(np.array([1.0, 0.5, 2.0], np.float32))
    jc = JaxCamera()
    jc.move(np.array([1.0, 0.5, 2.0], np.float32))
    np.testing.assert_array_equal(cam.position, jc.position)


@pytest.mark.parametrize("yaw,pitch", [(np.pi / 2, -0.12), (0.3, -0.4),
                                       (np.pi, 0.2)])
def test_cull_mask_exact(showcase, yaw, pitch):
    cam = Camera()
    cam.position[:] = showcase.camera.position
    cam.set_yaw_pitch(yaw, pitch)
    view, proj = _camera_mats(cam, 1920, 1080)
    r = showcase.render
    args = (r["ent_aabb_min"], r["ent_aabb_max"], r["ent_has_mesh"],
            showcase.world, view, proj)
    port = entity_frustum_mask(*(torch.as_tensor(a) for a in args))
    np.testing.assert_array_equal(port.numpy(), np.asarray(jax_cull(*args)))


def test_transforms_clip_and_setup(showcase):
    clip_j, tri_valid, (sc_j, sb_j, sv_j), tri_j = _setup(W, H)
    view, proj = _camera_mats(showcase.camera, W, H)
    r = showcase.render
    t = torch.as_tensor
    wp, clip = rz.transform_vertices(t(r["v_pos"]), t(r["v_entity"]),
                                     t(showcase.world), t(view), t(proj))
    np.testing.assert_allclose(clip.numpy(), clip_j, **F_TOL)
    wp_j, _ = jrz.transform_vertices(r["v_pos"], r["v_entity"],
                                     showcase.world, view, proj)
    np.testing.assert_allclose(wp.numpy(), np.asarray(wp_j), **F_TOL)
    nm = math3d.normal_matrix(t(showcase.world))
    np.testing.assert_allclose(
        rz.transform_normals(t(r["v_nrm"]), t(r["v_entity"]), nm).numpy(),
        np.asarray(jrz.transform_normals(r["v_nrm"], r["v_entity"],
                                         jm.normal_matrix(showcase.world))),
        **F_TOL)

    n_tri = clip_j.shape[0] // 3
    sub_clip, sub_bary, sub_valid = rz.clip_near_plane(
        t(clip_j).reshape(n_tri, 3, 4), t(tri_valid))
    assert int(sub_valid[:, 1].sum()) > 0          # the ground is clipped
    np.testing.assert_array_equal(sub_valid.numpy(), np.asarray(sv_j))
    np.testing.assert_allclose(sub_clip.numpy(), np.asarray(sc_j), **F_TOL)
    np.testing.assert_allclose(sub_bary.numpy(), np.asarray(sb_j), **F_TOL)

    # the same sub-triangles through both setups (eagerly on the JAX side,
    # as the port runs)
    tri_j = jrz.setup_triangles(sc_j.reshape(-1, 3, 4), sv_j.reshape(-1),
                                W, H)
    tri = rz.setup_triangles(t(sc_j).reshape(-1, 3, 4),
                             t(sv_j).reshape(-1), W, H)
    np.testing.assert_array_equal(tri["valid"].numpy(),
                                  np.asarray(tri_j["valid"]))
    for k in ("sx", "sy", "z", "inv_w", "area"):
        np.testing.assert_allclose(tri[k].numpy(), np.asarray(tri_j[k]),
                                   err_msg=k, **F_TOL)
    for a, b in zip(tri["bbox"], tri_j["bbox"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F_TOL)


@pytest.mark.parametrize("width,height,k_local", [(1920, 1080, 2048),
                                                  (W, H, 64)])
def test_bin_triangles_exact(showcase, width, height, k_local):
    _, _, _, tri_j = _setup(width, height)
    rw, rh = -(-width // 128) * 128, -(-height // 32) * 32
    out_j = _jax_bin(tri_j, rw, rh, k_local=k_local)
    out = rz.bin_triangles(_torch_tri(tri_j), rw, rh, k_local=k_local)
    for name, a, b in zip(("ids", "counts", "local_counts", "overflow"),
                          out[:4], out_j[:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    assert out[4] == out_j[4]
    if k_local == 64:
        assert int(out[3]) > 0                     # capacity reached


def _walk_inputs():
    """The walk's inputs for the showcase at the test size, as the JAX
    rasterizer builds them: (ids, tri, counts_walk, tri_pack, tiles_x)."""
    _, _, _, tri_j = _setup(W, H)
    ids, _, local_counts, _, (_, tiles_x) = _jax_bin(tri_j, 256, 160,
                                                     k_local=2048)
    ids = ids[:, :rz.K_GLOBAL + rz.HEAVY_CAPACITY]
    pack, _ = _jax_pack(ids, tri_j["sx"], tri_j["sy"], tri_j["z"])
    counts = rz.K_GLOBAL + np.minimum(np.asarray(local_counts),
                                      rz.HEAVY_CAPACITY)
    return (np.array(ids), tri_j, counts.astype(np.int32), np.array(pack),
            int(tiles_x))


def test_pack_tile_triangles_exact(showcase):
    ids, tri_j, _, pack_j, _ = _walk_inputs()
    pack, k_pad = rz.pack_tile_triangles(
        torch.as_tensor(ids), *(torch.as_tensor(tri_j[k])
                                for k in ("sx", "sy", "z")))
    assert k_pad == pack_j.shape[1]
    np.testing.assert_array_equal(pack.numpy(), pack_j)


def _random_pack(n_tiles, k_pad, seed, tiles_x):
    """Random triangles over each tile, ok = 0 at and beyond the count.
    The triangles are not slivers (corners 120 degrees apart, give or take
    30, at 8 to 60 pixels), so depth is well conditioned."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, k_pad + 1, n_tiles).astype(np.int32)
    counts[:2] = (0, k_pad)
    shape = (n_tiles, k_pad)
    ox = (np.arange(n_tiles) % tiles_x)[:, None] * 128.0
    oy = (np.arange(n_tiles) // tiles_x)[:, None] * 32.0
    cx = ox + rng.uniform(-10, 138, shape)
    cy = oy + rng.uniform(-10, 42, shape)
    ang = (rng.uniform(0, 2 * np.pi, shape)[..., None]
           + np.array([0.0, 2.1, 4.2]) + rng.uniform(-0.5, 0.5, shape + (3,)))
    rad = rng.uniform(8, 60, shape + (3,))
    pack = np.zeros(shape + (PACK_CH,), np.float32)
    pack[..., 0:3] = cx[..., None] + rad * np.cos(ang)
    pack[..., 3:6] = cy[..., None] + rad * np.sin(ang)
    pack[..., 6:9] = rng.uniform(-0.2, 1.2, shape + (3,))
    pack[..., 9] = np.arange(k_pad)[None, :] < counts[:, None]
    return counts, pack


def _walk_agrees(counts, pack, tiles_x):
    dep_j, slot_j = raster_walk_pallas(
        jnp.asarray(counts), jnp.asarray(pack), px=4096, tile_w=128,
        tiles_x=tiles_x, interpret=True)
    dep, slot = raster_walk(torch.as_tensor(counts), torch.as_tensor(pack),
                            tiles_x)
    slot_j, dep_j = np.asarray(slot_j), np.asarray(dep_j)
    same = slot.numpy() == slot_j
    assert same.mean() >= 0.9999, f"{(~same).sum()} slots differ"
    np.testing.assert_allclose(dep.numpy()[same], dep_j[same], atol=1e-6,
                               rtol=0)
    return slot.numpy()


def test_walk_matches_pallas_interpret(showcase):
    _, _, counts, pack, tiles_x = _walk_inputs()
    slot = _walk_agrees(counts, pack, tiles_x)
    assert (slot >= 0).any() and (slot < 0).any()


def test_walk_random_ragged_matches_pallas_interpret():
    counts, pack = _random_pack(11, 272, seed=5, tiles_x=4)
    slot = _walk_agrees(counts, pack, tiles_x=4)
    assert (slot >= 128).any()                     # the wide slots win too


def test_walk_degenerate_rows_match_pallas_interpret():
    """Zero-area rows, corners on pixel centres, slivers along a pixel row,
    triangles far larger than the tile, depth ties, counts 0, 1 and 272:
    every edge function and depth here is exact in f32, so the plain walk
    (and the CUDA kernel, held to it on the card) equals the Pallas kernel
    exactly.  A zero-area line covers pixels on it outside its bounding
    box; a walk that skipped slots by their boxes would lose them."""
    counts, pack = kernel_cases.walk_edge_case()
    dep_j, slot_j = raster_walk_pallas(
        jnp.asarray(counts), jnp.asarray(pack), px=4096, tile_w=128,
        tiles_x=5, interpret=True)
    dep, slot = raster_walk(torch.as_tensor(counts), torch.as_tensor(pack), 5)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(slot_j))
    np.testing.assert_array_equal(dep.numpy(), np.asarray(dep_j))
    r, c = kernel_cases.WALK_LINE_PIXEL
    assert int(slot[kernel_cases.WALK_LINE_TILE, r * 128 + c]) == 0
    assert (slot[0] == -1).all() and (slot[2] >= 128).any()


@pytest.mark.parametrize("case", ["edge", "random", "showcase",
                                  "showcase_light", "showcase_heavy"])
def test_walk_cover_boxes_hold_every_covered_pixel(case):
    """The banded walk (the walk kernel, the fused kernel and the tile
    raster) skips a slot for a warp whose pixels all lie outside the
    slot's cover box; no pixel centre outside the box may be covered (the
    bound is proved in csrc/tile_walk.cuh).  Checked here on every (pixel,
    used slot) pair with the plain coverage test, on walk packs and on the
    full-carry raster's light and heavy passes of the showcase, whose
    listed tiles' pixel centres are those of their screen tiles."""
    tile_ids = None
    if case == "edge":
        counts, pack = kernel_cases.walk_edge_case()
        tiles_x = 5
    elif case == "random":
        counts, pack = _random_pack(11, 272, seed=5, tiles_x=4)
        tiles_x = 4
    elif case == "showcase":
        _, _, counts, pack, tiles_x = _walk_inputs()
    else:
        clip, tri_valid, _, _ = _setup(W, H)
        b = rz._bin_frame(torch.as_tensor(clip), torch.as_tensor(tri_valid),
                          W, H, 2048)
        tile_ids, x, y, z, _, _, _, ok, tiles_x = (
            rz._light_pass(b) if case == "showcase_light"
            else rz._heavy_pass(b))
        pack = kernel_cases.carry_pack(x, y, z, ok)
    pack = torch.as_tensor(pack)
    if tile_ids is None:
        tile_ids = torch.arange(pack.shape[0])
    box = cover_boxes(pack)
    px, py = pixel_centres(tile_ids, tiles_x)
    px, py = px[:, None], py[:, None]                  # [tiles, 1, 4096]
    covered = 0
    for base in range(0, pack.shape[1], 8):
        rows = pack[:, base:base + 8]
        cover, *_ = slot_coverage(*(rows[:, :, j, None] for j in range(9)),
                                  px, py)
        cover &= rows[:, :, 9, None] > 0
        b = box[:, base:base + 8, None, :]
        inside = ((px >= b[..., 0]) & (px <= b[..., 1]) & (py >= b[..., 2])
                  & (py <= b[..., 3]))
        assert not bool((cover & ~inside).any())
        covered += int(cover.sum())
    assert covered > 0
    used = pack[..., 9] > 0
    narrow = (box[..., 1] - box[..., 0] < 200.0)[used].float().mean()
    if case == "edge":                # zero-area rows keep the whole plane
        whole = torch.isinf(box[..., 0])[used]
        assert bool(whole.any()) and not bool(whole.all())
    elif case == "showcase_light":    # its 48 locals hold larger triangles
        assert float(narrow) > 0.75
    else:
        assert float(narrow) > 0.9


def test_walk_plain_ignores_slots_beyond_count():
    counts, pack = _random_pack(3, 24, seed=2, tiles_x=3)
    pack[..., 9] = 1.0                  # rows past the count marked used
    dep, slot = raster_walk_reference(torch.as_tensor(counts),
                                      torch.as_tensor(pack), 3)
    for t, c in enumerate(counts):
        assert int(slot[t].max()) < max(int(c), 0) or int(slot[t].max()) == -1
    # the same as a pack whose padding rows are cleared
    pack[..., 9] = np.arange(24)[None, :] < counts[:, None]
    dep2, slot2 = raster_walk_reference(torch.as_tensor(counts),
                                        torch.as_tensor(pack), 3)
    assert torch.equal(slot, slot2) and torch.equal(dep, dep2)


def _random_resolve(n_tiles, c, kl, seed):
    rng = np.random.default_rng(seed)
    slot = rng.integers(-1, kl + 40, (n_tiles, 4096)).astype(np.int32)
    slot[0] = -1                                   # an all-sky tile
    slot[1] = rng.integers(-1, 48, 4096)           # a light tile
    table = rng.standard_normal((n_tiles, c, kl)).astype(np.float32)
    table[2, 3, 5] = -0.0
    return slot, table


@pytest.mark.parametrize("n_tiles,c,kl", [(10, 40, 272), (3, 7, 64)])
def test_resolve_matches_pallas_interpret(n_tiles, c, kl):
    slot, table = _random_resolve(n_tiles, c, kl, seed=n_tiles)
    assert np.isfinite(table).all()    # the one-hot product needs it
    out_j = resolve_tiles_pallas_wide(jnp.asarray(slot), jnp.asarray(table),
                                      jnp.asarray(slot.max(axis=1)),
                                      interpret=True)
    out = resolve_tiles_wide(torch.as_tensor(slot), torch.as_tensor(table))
    assert out.shape == (c, n_tiles, 4096)
    np.testing.assert_array_equal(out.numpy(), np.asarray(out_j))
    assert torch.equal(out, resolve_tiles_wide_reference(
        torch.as_tensor(slot), torch.as_tensor(table)))


def test_kernel_wrappers_reject_bad_input():
    counts, pack = _random_pack(2, 8, seed=0, tiles_x=2)
    with pytest.raises(ValueError):
        raster_walk(torch.as_tensor(counts).long(), torch.as_tensor(pack), 2)
    with pytest.raises(ValueError):
        resolve_tiles_wide(torch.zeros((2, 4096), dtype=torch.int64),
                           torch.zeros((2, 3, 4)))


def test_walk_overflow_counted_once(showcase):
    """The JAX walk route counts local pairs beyond ``bin_capacity`` twice
    (once in the binner, once against the walk width); the port counts
    every dropped pair once."""
    clip, tri_valid, _, tri_j = _setup(W, H)
    cap = 64
    _, over_j = _jax_rasterize(clip, tri_valid, W, H, bin_capacity=cap,
                               backend="walk", slim=True)
    vis, over = rz.rasterize(torch.as_tensor(clip), torch.as_tensor(tri_valid),
                             W, H, bin_capacity=cap)
    *_, local_counts, _, _ = _jax_bin(tri_j, 256, 160, k_local=cap)
    twice = np.maximum(np.asarray(local_counts) - cap, 0).sum()
    assert twice > 0
    assert int(over_j) - int(over) == twice
    assert vis.tri_id is None and vis.depth.shape == (H, W)


def test_walk_refuses_full_carry_and_other_backends(showcase):
    clip, tri_valid, _, _ = _setup(W, H)
    args = (torch.as_tensor(clip), torch.as_tensor(tri_valid), W, H)
    with pytest.raises(ValueError, match="slim"):
        rz.rasterize(*args, slim=False)
    for backend in ("xla", "auto", "pallas", "pallas_interpret"):
        with pytest.raises(ValueError, match="ROADMAP"):
            rz.rasterize(*args, backend=backend)
    # the full carry is the "tile" backend, which is no full walk
    vis, _, tiled = rz.rasterize(*args, backend="tile", slim=False,
                                 return_tiled=True)
    assert vis.tri_id is not None and tiled.full_walk is False


def test_full_walk_field_sets_the_resolve_width(showcase):
    """``TiledVisibility.full_walk`` (an explicit field, where the JAX
    package reads an empty ``heavy`` array) lets the resolve cover the walk
    width; without it the resolve covers ``shade_slots`` (64 by default)
    and the winners beyond take the row-gather fallback, which gathers the
    same rows: the frame is the same."""
    clip, tri_valid, _, _ = _setup(W, H)
    t = torch.as_tensor
    _, _, tiled = rz.rasterize(t(clip), t(tri_valid), W, H,
                               return_tiled=True)
    assert tiled.full_walk is True
    assert tiled.ids.shape[1] == rz.K_GLOBAL + rz.HEAVY_CAPACITY
    rs = convert.render_scene_from_numpy(showcase.render, "cpu")
    view, proj = _camera_mats(showcase.camera, W, H)
    n = rs.v_pos.shape[0]
    args = (W, H, rs.v_nrm, rs.v_uv, torch.ones(n), rs.tri_material,
            rs.mat_base_tint, rs.mat_uv_scale, rs.mat_spec_color, rs.mat_tex,
            rs.textures, rs.tex_size, rs.textures_quad_t,
            t(showcase.camera.position), LightParams.default("cpu"), t(view),
            t(proj))
    frame = shade_visibility_tiled(tiled, *args)
    assert frame.shape == (H, W, 4)
    narrow = dataclasses.replace(tiled, full_walk=False)
    assert int((narrow.slot >= 64).sum()) > 0       # the fallback fires
    assert torch.equal(shade_visibility_tiled(narrow, *args), frame)


def test_convert_render_scene_round_trip(showcase):
    rs = convert.render_scene_from_numpy(showcase.render, "cpu")
    back = convert.render_scene_to_numpy(rs)
    assert back.keys() == showcase.render.keys()
    for k, a in showcase.render.items():
        assert back[k].dtype == a.dtype, k
        np.testing.assert_array_equal(back[k], a, err_msg=k)


def _write_scene(d):
    """Two meshes (a box OBJ with two submeshes and a triangle fan), three
    entities, a named material with a missing texture (checker), an MTL
    material and the default one."""
    (d / "box.mtl").write_text(
        "newmtl red\nKd 0.8 0.1 0.1\nnewmtl blue\nKd 0.1 0.2 0.9\n"
        "map_Kd missing_blue.png\n")
    v = [(x, y, z) for x in (-0.5, 0.5) for y in (-0.5, 0.5)
         for z in (-0.5, 0.5)]
    lines = ["mtllib box.mtl"] + [f"v {x} {y} {z}" for x, y, z in v]
    lines += ["vt 0 0", "vt 1 0", "vt 1 1", "vt 0 1", "vn 0 0 1"]
    lines += ["usemtl red", "f 1/1/1 2/2/1 4/3/1 3/4/1",
              "f 5/1/1 7/2/1 8/3/1 6/4/1", "usemtl blue",
              "f 1/1/1 5/2/1 6/3/1 2/4/1", "f 3/1/1 4/2/1 8/3/1 7/4/1",
              "f 1/1/1 3/2/1 7/3/1 5/4/1"]
    (d / "box.obj").write_text("\n".join(lines) + "\n")
    (d / "fan.obj").write_text(
        "v 0 0 0\nv 2 0 0\nv 2 0 2\nv 0 0 2\nv -1 1 1\n"
        "f 1 2 3\nf 1 3 4\nf 1 4 5\nf 1 5 2\n")
    scene = {
        "resources": {
            "textures": {"stone": "textures/missing_stone.png"},
            "materials": {"rock": {"baseTint": [0.5, 0.6, 0.7, 1.0],
                                   "uvScale": [2, 3],
                                   "albedoTex": "stone"},
                          "plain": {"baseTint": [1, 0.9, 0.8, 1]}},
            "meshes": {"box": {"obj": str(d / "box.obj"),
                               "mtl": str(d / "box.mtl")},
                       "fan": str(d / "fan.obj")},
        },
        "entities": [
            {"id": "a", "meshRenderer": {"mesh": "box"},
             "transform": {"position": [0, 1, 0]}},
            {"id": "b", "meshRenderer": {"mesh": "fan", "material": "rock"}},
            {"id": "c"},
            {"id": "d", "meshRenderer": {"mesh": "box",
                                         "materialOverrides": {"1": "plain"}}},
        ],
    }
    (d / "scene.json").write_text(json.dumps(scene))
    return str(d / "scene.json")


def test_packer_matches_build_scene(tmp_path):
    """The port's packer, fed the triangle soup, textures and material
    table that the JAX builder expanded, gives its 21 arrays exactly."""
    path = _write_scene(tmp_path)
    built = build_scene(parse_scene_json(path),
                        ResourceManager(assets_root=str(tmp_path)))
    ref = {f.name: np.asarray(getattr(built.render, f.name))
           for f in dataclasses.fields(built.render)}
    n_tri = int(ref["tri_valid"].sum())
    soup = {k: ref[k][:3 * n_tri] for k in ("v_pos", "v_nrm", "v_uv",
                                            "v_entity")}
    textures = [ref["textures"][i, :h, :w]
                for i, (w, h) in enumerate(ref["tex_size"])]
    assert any(t.shape == (2, 2, 4) for t in textures)     # the checker
    port = pack_render_scene(
        **soup, tri_material=ref["tri_material"][:n_tri], textures=textures,
        **{k: ref[k] for k in ("mat_base_tint", "mat_uv_scale",
                               "mat_spec_params", "mat_spec_color",
                               "mat_tex")},
        capacity=ref["ent_has_mesh"].shape[0])
    assert port.keys() == ref.keys()
    for k, a in ref.items():
        assert port[k].dtype == a.dtype and port[k].shape == a.shape, k
        np.testing.assert_array_equal(port[k], a, err_msg=k)
