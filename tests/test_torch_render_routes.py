"""The port's fused and full-carry frame routes against the JAX package on
the CPU.

Every part gets the same numpy inputs on both sides.  The Pallas kernels of
the JAX package run in interpret mode, as its own CPU tests run them
(``raster_backend="pallas_interpret"`` for the full-carry tile kernel; the
fused kernel takes interpret mode by itself on a CPU backend); the port
runs the plain versions of its CUDA kernels, which is what a CPU tensor
gets.

Tolerances, as in ``test_torch_render_parts.py``: slots and triangle ids
equal on >= 99.99 % of pixels (a pixel exactly on an edge may flip: JAX's
CPU compiler fuses multiply-adds, PyTorch's eager ops do not), depth
within 1e-6 where the slots agree, barycentrics within 1e-5 where the ids
agree (``tests/test_raster_pallas.py``), resolved planes exact given the
same slots; frames within 1 level on >= 99.9 % of pixels, as
``test_torch_render_frame.py`` holds the tiled frame.  The port's own
routes equal each other exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banggameengine_tpu.render import raster as jrz
from banggameengine_tpu.render.cull import entity_frustum_mask as jax_cull
from banggameengine_tpu.render.pipeline import render_frame as jax_render
from banggameengine_tpu.render.raster_pallas import raster_tiles_pallas
from banggameengine_tpu.render.raster_resolve_pallas import (
    raster_resolve_tiles_pallas,
)
from banggameengine_tpu.render.resolve_pallas import (
    resolve_tiles_pallas,
    resolve_tiles_pallas_wide,
)
from banggameengine_tpu.scene.build import RenderScene as JaxRenderScene
from banggameengine_tpu_torch import convert, kernel_cases
from banggameengine_tpu_torch.render import raster as rz
from banggameengine_tpu_torch.render.pipeline import make_render_fn
from banggameengine_tpu_torch.render.raster_resolve import (
    raster_resolve_tiles,
    raster_resolve_tiles_reference,
)
from banggameengine_tpu_torch.render.raster_tile import (
    raster_tiles,
    raster_tiles_reference,
)
from banggameengine_tpu_torch.render.raster_walk import PACK_CH, raster_walk
from banggameengine_tpu_torch.render.resolve import (
    resolve_tiles_wide,
    resolve_tiles_wide_reference,
)
from banggameengine_tpu_torch.scene.synthetic import build_showcase_render

W, H = 256, 160
SKY = (0x88, 0xAA, 0xFF, 0xFF)

_jax_bin = jax.jit(jrz.bin_triangles, static_argnums=(1, 2),
                   static_argnames=("k_local",))
_jax_prep = jax.jit(jrz.prepare_fused_raster, static_argnums=(2, 3),
                    static_argnames=("bin_capacity",))
_jax_rasterize = jax.jit(jrz.rasterize, static_argnums=(2, 3),
                         static_argnames=("bin_capacity", "backend"))


@functools.cache
def _showcase():
    return build_showcase_render(0)


@functools.cache
def _showcase_front():
    """The JAX package's clip and cull of the showcase at W x H, as numpy:
    (clip, tri_valid, tri (setup), sub_bary)."""
    sc = _showcase()
    r = sc.render
    view = sc.camera.view_matrix("cpu").numpy()
    proj = sc.camera.proj_matrix(W / H, "cpu").numpy()

    @jax.jit
    def front(world):
        vis = jax_cull(r["ent_aabb_min"], r["ent_aabb_max"],
                       r["ent_has_mesh"], world, view, proj)
        tri_valid = r["tri_valid"] & vis[r["v_entity"][::3]]
        _, clip = jrz.transform_vertices(r["v_pos"], r["v_entity"], world,
                                         view, proj)
        t = clip.shape[0] // 3
        sub_clip, sub_bary, sub_valid = jrz.clip_near_plane(
            clip.reshape(t, 3, 4), tri_valid)
        tri = jrz.setup_triangles(sub_clip.reshape(2 * t, 3, 4),
                                  sub_valid.reshape(2 * t), W, H)
        return clip, tri_valid, tri, sub_bary.reshape(2 * t, 3, 3)

    return jax.tree.map(np.array, front(sc.world))


def _random_pack(n_tiles, k_pad, seed, tiles_x):
    """Random triangles over each tile, ragged counts with ok = 0 at and
    beyond each, corners 120 degrees apart give or take 30 at 8 to 60
    pixels (no slivers, so depth is well conditioned)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, k_pad + 1, n_tiles).astype(np.int32)
    counts[:2] = (0, k_pad)
    shape = (n_tiles, k_pad)
    cx = (np.arange(n_tiles) % tiles_x)[:, None] * 128.0 + rng.uniform(
        -10, 138, shape)
    cy = (np.arange(n_tiles) // tiles_x)[:, None] * 32.0 + rng.uniform(
        -10, 42, shape)
    ang = (rng.uniform(0, 2 * np.pi, shape)[..., None]
           + np.array([0.0, 2.1, 4.2]) + rng.uniform(-0.5, 0.5, shape + (3,)))
    rad = rng.uniform(8, 60, shape + (3,))
    pack = np.zeros(shape + (PACK_CH,), np.float32)
    pack[..., 0:3] = cx[..., None] + rad * np.cos(ang)
    pack[..., 3:6] = cy[..., None] + rad * np.sin(ang)
    pack[..., 6:9] = rng.uniform(-0.2, 1.2, shape + (3,))
    pack[..., 9] = np.arange(k_pad)[None, :] < counts[:, None]
    return counts, pack


def _slots_agree(slot, slot_j, depth, depth_j):
    """Slots equal on >= 99.99 % of pixels, depth within 1e-6 where they
    agree; returns the agreement mask."""
    same = slot == slot_j
    assert same.mean() >= 0.9999, f"{(~same).sum()} slots differ"
    np.testing.assert_allclose(depth[same], depth_j[same], atol=1e-6, rtol=0)
    return same


# ---- kernel #4: the fused walk + resolve ----------------------------------


@functools.cache
def _fused_case(name):
    """(counts, tri_pack, tables, tiles_x): the showcase's walk inputs from
    the JAX package's prepare_fused_raster with a random finite table at
    the walk width, or random ragged counts over 11 tiles."""
    if name == "showcase":
        clip, tri_valid, _, _ = _showcase_front()
        prep = _jax_prep(clip, tri_valid, W, H, bin_capacity=2048)
        counts, pack = np.array(prep.counts_walk), np.array(prep.tri_pack)
        tiles_x, kl = int(prep.tiles_x), prep.ids_w.shape[1]
    else:
        tiles_x, kl = 4, 260
        counts, pack = _random_pack(11, 272, seed=9, tiles_x=tiles_x)
    rng = np.random.default_rng(len(name))
    table = rng.standard_normal((pack.shape[0], 40, kl)).astype(np.float32)
    table[0, 3, 5] = -0.0
    return counts, pack, table, tiles_x


@pytest.mark.parametrize("case", ["showcase", "random"])
@pytest.mark.parametrize("with_tables", [True, False])
def test_raster_resolve_matches_pallas_interpret(case, with_tables):
    counts, pack, table, tiles_x = _fused_case(case)
    table = table if with_tables else None
    dep_j, slot_j, res_j = raster_resolve_tiles_pallas(
        jnp.asarray(counts), jnp.asarray(pack),
        None if table is None else jnp.asarray(table), px=4096, tile_w=128,
        tiles_x=tiles_x, interpret=True)
    t = torch.as_tensor
    dep, slot, res = raster_resolve_tiles(
        t(counts), t(pack), None if table is None else t(table), tiles_x)
    slot_j = np.array(slot_j)
    same = _slots_agree(slot.numpy(), slot_j, dep.numpy(), np.asarray(dep_j))
    assert (slot_j >= 0).any() and (slot_j < 0).any()
    if table is None:
        assert res is None and res_j is None
        return
    # exact given the same slots: the JAX planes are the port's resolve of
    # the JAX slots, and the port's planes agree wherever the slots do
    res_j = np.asarray(res_j)
    np.testing.assert_array_equal(
        resolve_tiles_wide_reference(t(slot_j), t(table)).numpy(), res_j)
    np.testing.assert_array_equal(res.numpy()[:, same], res_j[:, same])


def test_fused_overflow_counted_once():
    """The JAX package's prepare_fused_raster counts the local pairs beyond
    ``bin_capacity`` twice (ADVICE.md #2); the port counts each dropped
    pair once."""
    clip, tri_valid, tri_j, _ = _showcase_front()
    cap = 64
    prep_j = _jax_prep(clip, tri_valid, W, H, bin_capacity=cap)
    prep = rz.prepare_fused_raster(torch.as_tensor(clip),
                                   torch.as_tensor(tri_valid), W, H,
                                   bin_capacity=cap)
    *_, local, _, _ = _jax_bin(tri_j, 256, 160, k_local=cap)
    twice = np.maximum(np.asarray(local) - cap, 0).sum()
    assert twice > 0
    assert int(prep_j.overflow) - int(prep.overflow) == twice
    np.testing.assert_array_equal(prep.counts_walk.numpy(),
                                  np.asarray(prep_j.counts_walk))


# ---- kernel #5: the full-carry tile raster --------------------------------


def _gathered(ids, tri, sub_bary, chunk=8):
    """The JAX rasterizer's per-tile gather of ``ids`` [n, K], numpy:
    (x, y, z, oid, cb1, cb2, ok) with K padded to a multiple of 8."""
    safe = np.maximum(ids, 0)
    pad = (-ids.shape[1]) % chunk
    cb = sub_bary[safe]
    rows = (tri["sx"][safe], tri["sy"][safe], tri["z"][safe],
            (safe // 2).astype(np.int32), cb[..., 1], cb[..., 2],
            (ids >= 0).astype(np.int32))
    return tuple(np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
                 for a in rows)


@functools.cache
def _tile_case(name):
    """(tile_idx, x, y, z, oid, cb1, cb2, ok, tiles_x): a heavy-pass tile
    subset of the showcase at 272 slots, or random triangles over 9 listed
    tiles of a 5-wide grid."""
    if name == "showcase":
        _, _, tri, sub_bary = _showcase_front()
        ids, *_ = _jax_bin(tri, 256, 160, k_local=2048)
        tile_idx = np.array([7, 2, 9, 4, 3], np.int32)
        rows = _gathered(np.asarray(ids)[tile_idx, :272], tri, sub_bary)
        return (tile_idx,) + rows + (2,)
    rng = np.random.default_rng(4)
    tile_idx = rng.permutation(15)[:9].astype(np.int32)
    counts, pack = _random_pack(9, 40, seed=3, tiles_x=5)
    # each random row sits over its listed tile's screen position
    ox = (tile_idx % 5 - np.arange(9) % 5)[:, None, None] * 128.0
    oy = (tile_idx // 5 - np.arange(9) // 5)[:, None, None] * 32.0
    cb = rng.uniform(0, 1, (9, 40, 2, 3)).astype(np.float32)
    oid = rng.integers(0, 1000, (9, 40)).astype(np.int32)
    return (tile_idx, (pack[..., 0:3] + ox).astype(np.float32),
            (pack[..., 3:6] + oy).astype(np.float32), pack[..., 6:9], oid,
            cb[:, :, 0], cb[:, :, 1], pack[..., 9].astype(np.int32), 5)


@pytest.mark.parametrize("case", ["showcase", "random"])
def test_raster_tiles_matches_pallas_interpret(case):
    *args, tiles_x = _tile_case(case)
    out_j = [np.asarray(a) for a in raster_tiles_pallas(
        *map(jnp.asarray, args), tiles_x, interpret=True)]
    out = [a.numpy() for a in raster_tiles(*map(torch.as_tensor, args),
                                           tiles_x)]
    (dep, tid, b1, b2, slot), (dep_j, tid_j, b1_j, b2_j, slot_j) = out, out_j
    assert dep.shape == (len(args[0]), 32, 128)
    same = _slots_agree(slot, slot_j, dep, dep_j)
    ids_same = (tid == tid_j) & same
    assert ids_same.mean() >= 0.9999
    np.testing.assert_allclose(b1[ids_same], b1_j[ids_same], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(b2[ids_same], b2_j[ids_same], atol=1e-5,
                               rtol=0)
    assert (slot_j >= 0).any() and (slot_j < 0).any()
    assert (tid[slot < 0] == -1).all() and (b1[slot < 0] == 0).all()


def test_raster_tiles_edge_case_matches_pallas_interpret():
    """The walk's edge rows (zero-area lines, corners on pixel centres,
    slivers, huge triangles, ties) as full-carry arguments over 13 tiles
    listed in a shuffled order: every edge function, depth and
    barycentric is exact in f32, so the plain version (and the CUDA
    kernel, held to it on the card, which skips slots by their cover
    boxes) equals the Pallas kernel exactly, and its depth and slot equal
    the walk's on the same rows."""
    *args, tiles_x = kernel_cases.tile_edge_case()
    out_j = [np.asarray(a) for a in raster_tiles_pallas(
        *map(jnp.asarray, args), tiles_x, interpret=True)]
    out = raster_tiles_reference(*map(torch.as_tensor, args), tiles_x)
    for name, a, a_j in zip(("depth", "tri_id", "b1", "b2", "slot"), out,
                            out_j):
        np.testing.assert_array_equal(a.numpy(), a_j, err_msg=name)
    item = int(np.flatnonzero(args[0] == kernel_cases.WALK_LINE_TILE)[0])
    r, c = kernel_cases.WALK_LINE_PIXEL
    assert int(out[4][item, r, c]) == 0
    counts, pack = kernel_cases.walk_edge_case()
    dep_w, slot_w = raster_walk(torch.as_tensor(counts),
                                torch.as_tensor(pack), tiles_x)
    order = torch.as_tensor(args[0]).long()
    assert torch.equal(out[4].reshape(len(order), -1), slot_w[order])
    assert torch.equal(out[0].reshape(len(order), -1), dep_w[order])


def _dense_scene():
    """A 1280x288 frame of 10 x 9 tiles where 80 tiles hold 60 small local
    triangles each (equal counts, more than 48) and the rest 20: more than
    64 tiles want the heavy pass, so the tie order of the top 64 decides
    which tiles drop their last 12 triangles.  Later triangles of a tile
    lie nearer and cover the earlier ones, so a dropped triangle changes
    the picture.  Clip space with w = 1: (clip, tri_valid)."""
    width, height = 1280, 288
    rng = np.random.default_rng(12)
    tris = []
    for tile in range(90):
        n = 60 if tile < 80 else 20
        ox, oy = (tile % 10) * 128.0, (tile // 10) * 32.0
        for i in range(n):
            cx = ox + 20 + rng.uniform(0, 88)
            cy = oy + 6 + rng.uniform(0, 20)
            z = 0.9 - 0.012 * i
            ang = rng.uniform(0, 2 * np.pi) + np.array([0.0, 2.1, 4.2])
            sx = cx + 14 * np.cos(ang)
            sy = cy + 5 * np.sin(ang)
            tris.append([(x / width * 2 - 1, 1 - 2 * y / height, z, 1.0)
                         for x, y in zip(sx, sy)])
    clip = np.asarray(tris, np.float32).reshape(-1, 4)
    return clip, np.ones(len(tris), bool), width, height


@pytest.mark.parametrize("case", ["showcase", "showcase_cap64", "dense"])
def test_rasterize_tile_matches_jax(case):
    """``rasterize(backend="tile")`` against the JAX rasterizer: its Pallas
    tile kernel in interpret mode on the showcase, its XLA full-carry scan
    on the dense case.  The dense case pins the top-64 tie order (lower
    tile index first among equal counts) and, with ``bin_capacity`` 56,
    the overflow rule: the JAX light/heavy route counts the locals beyond
    ``bin_capacity`` twice, the port once."""
    if case == "dense":
        clip, tri_valid, width, height = _dense_scene()
        cap, backend = 56, "xla"
    else:
        clip, tri_valid, _, _ = _showcase_front()
        width, height = W, H
        cap, backend = (64, "pallas_interpret") if case.endswith("64") else (
            2048, "pallas_interpret")
    vis_j, over_j = _jax_rasterize(clip, tri_valid, width, height,
                                   bin_capacity=cap, backend=backend)
    vis, over = rz.rasterize(torch.as_tensor(clip),
                             torch.as_tensor(tri_valid), width, height,
                             bin_capacity=cap, backend="tile", slim=False)
    tid, tid_j = vis.tri_id.numpy(), np.asarray(vis_j.tri_id)
    same = _slots_agree(tid, tid_j, vis.depth.numpy(),
                        np.asarray(vis_j.depth))
    for a, a_j in ((vis.b1, vis_j.b1), (vis.b2, vis_j.b2)):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(a_j)[same],
                                   atol=1e-5, rtol=0)

    # the overflow rule: JAX minus port = the locals beyond k_local
    t = clip.shape[0] // 3
    k_local = min(cap, 2 * t)
    b = rz._bin_frame(torch.as_tensor(clip), torch.as_tensor(tri_valid),
                      width, height, cap)
    local = b.local_counts.numpy()
    twice = np.maximum(local - k_local, 0).sum()
    assert int(over_j) - int(over) == twice
    if case == "dense":
        heavy_want = (local > rz.LIGHT_CAPACITY).sum()
        assert heavy_want > rz.HEAVY_TILES and twice > 0
        assert len(set(local[local > rz.LIGHT_CAPACITY])) == 1   # all tied
        # the heavy pass took the 64 lowest-numbered tied tiles: the
        # others lost their nearest triangles
        assert int(over) == (80 - 64) * (60 - rz.LIGHT_CAPACITY) + 64 * (
            60 - k_local)
    elif case == "showcase":
        assert twice == 0 and (tid_j >= 0).any()


# ---- the frames -----------------------------------------------------------


@functools.cache
def _port_frames():
    """The port's showcase frame and depth by route at W x H, and the flat
    and tiled routes' overflow: ({route: (frame, depth)}, overflows)."""
    sc = _showcase()
    rs = convert.render_scene_from_numpy(sc.render, "cpu")
    args = (torch.as_tensor(sc.world), sc.camera.view_matrix("cpu"),
            sc.camera.proj_matrix(W / H, "cpu"),
            torch.as_tensor(sc.camera.position))
    out = {}
    for mode, backend in (("tiled", "walk"), ("fused", "walk"),
                          ("flat", "tile")):
        frame, depth = make_render_fn(rs, W, H, return_depth=True,
                                      shade_mode=mode,
                                      raster_backend=backend)(*args)
        out[mode] = (frame.numpy(), depth.numpy())
    clip, tri_valid, _, _ = _showcase_front()
    overflows = [int(rz.rasterize(torch.as_tensor(clip),
                                  torch.as_tensor(tri_valid), W, H,
                                  bin_capacity=512, backend=backend)[1])
                 for backend in ("walk", "tile")]
    return out, overflows


def test_fused_and_flat_frames_equal_the_tiled_frame():
    frames, (over_walk, over_tile) = _port_frames()
    frame, depth = frames["tiled"]
    for mode in ("fused", "flat"):
        assert np.array_equal(frames[mode][0], frame), mode
        assert np.array_equal(frames[mode][1], depth), mode
    assert over_walk == over_tile
    sky = (frame == SKY).all(-1)
    assert 0.2 < sky.mean() < 0.8


@pytest.mark.parametrize("mode", ["fused", "flat"])
def test_route_frame_matches_jax(mode):
    sc = _showcase()
    rs = JaxRenderScene(**{k: jnp.asarray(v) for k, v in sc.render.items()})
    backend = "pallas_interpret" if mode == "flat" else "auto"
    fn = jax.jit(functools.partial(jax_render, width=W, height=H,
                                   shade_mode=mode, raster_backend=backend,
                                   return_depth=True))
    frame_j, depth_j = fn(rs, jnp.asarray(sc.world),
                          sc.camera.view_matrix("cpu").numpy(),
                          sc.camera.proj_matrix(W / H, "cpu").numpy(),
                          jnp.asarray(sc.camera.position))
    frame_j, depth_j = np.asarray(frame_j), np.asarray(depth_j)
    frame, depth = _port_frames()[0][mode]
    assert frame.dtype == np.uint8 and frame.shape == (H, W, 4)
    off = np.abs(frame.astype(np.int32) - frame_j.astype(np.int32)).max(-1)
    assert (off > 1).mean() <= 0.001, f"{(off > 1).sum()} pixels off"
    sky, sky_j = (frame == SKY).all(-1), (frame_j == SKY).all(-1)
    assert not (sky != sky_j)[off <= 1].any()
    assert (np.abs(depth - depth_j) > 1e-6).mean() <= 0.001


# ---- kernel #6 and the wrappers -------------------------------------------


@pytest.mark.parametrize("n_tiles,c,kl", [(11, 13, 100), (3, 40, 272)])
def test_resolve_closes_the_fixed_width_pallas_kernel(n_tiles, c, kl):
    """``resolve_tiles_pallas`` (kernel #6, the fixed-width one-hot resolve)
    computes the function of the port's resolve: slots in [KL, KL_pad)
    meet zero pad rows and slots beyond match nothing."""
    rng = np.random.default_rng(n_tiles * c)
    slot = rng.integers(-1, kl + 130, (n_tiles, 4096)).astype(np.int32)
    slot[1] = -1
    table = rng.standard_normal((n_tiles, c, kl)).astype(np.float32)
    out_j = resolve_tiles_pallas(jnp.asarray(slot), jnp.asarray(table),
                                 interpret=True)
    out = resolve_tiles_wide_reference(torch.as_tensor(slot),
                                       torch.as_tensor(table))
    assert (slot >= 128).any() and out.shape == (c, n_tiles, 4096)
    np.testing.assert_array_equal(out.numpy(), np.asarray(out_j))


@pytest.mark.parametrize("kernel", ["resolve", "fused"])
def test_one_hot_resolve_spreads_an_unselected_inf(kernel):
    """The reference's one-hot resolve contracts each 128-slot chunk of a
    tile's table, and 0 * inf is NaN: one inf in a slot that no pixel
    selects turns that tile's whole channel to NaN.  The port's gather
    (and its fused kernel, held to it on the card) returns the selected
    entries, finite (ROADMAP §3)."""
    rng = np.random.default_rng(21)
    counts, pack = _random_pack(2, 16, seed=21, tiles_x=2)
    counts[:] = 16
    pack[..., 9] = 1.0
    pack[:, 5, 9] = 0.0                  # slot 5 is unused: nobody wins it
    table = rng.standard_normal((2, 6, 16)).astype(np.float32)
    table[1, 2, 5] = np.inf
    t = torch.as_tensor
    if kernel == "resolve":
        _, slot = raster_walk(t(counts), t(pack), 2)
        slot = slot.numpy()
        out_j = resolve_tiles_pallas_wide(
            jnp.asarray(slot), jnp.asarray(table),
            jnp.asarray(slot.max(axis=1)), interpret=True)
        out = resolve_tiles_wide(t(slot), t(table))
    else:
        _, slot_j, out_j = raster_resolve_tiles_pallas(
            jnp.asarray(counts), jnp.asarray(pack), jnp.asarray(table),
            px=4096, tile_w=128, tiles_x=2, interpret=True)
        _, slot, out = raster_resolve_tiles(t(counts), t(pack), t(table), 2)
        slot = slot.numpy()
        np.testing.assert_array_equal(slot, np.asarray(slot_j))
    out_j, out = np.asarray(out_j), out.numpy()
    assert (slot[1] >= 0).any() and not (slot == 5).any()
    assert np.isnan(out_j[2, 1]).all()   # the whole tile's channel
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(
        out, resolve_tiles_wide_reference(t(slot), t(table)).numpy())
    finite = np.ones(out_j.shape, bool)
    finite[2, 1] = False                 # everything else agrees
    np.testing.assert_array_equal(out[finite], out_j[finite])


def test_route_wrappers_reject_bad_input():
    counts, pack = _random_pack(2, 8, seed=0, tiles_x=2)
    t = torch.as_tensor
    with pytest.raises(ValueError):
        raster_resolve_tiles(t(counts), t(pack), torch.zeros((3, 4, 5)), 2)
    with pytest.raises(ValueError):
        raster_resolve_tiles(t(counts).long(), t(pack), None, 2)
    *args, tiles_x = _tile_case("random")
    args = [t(a) for a in args]
    bad = list(args)
    bad[7] = bad[7].to(torch.bool)                  # ok must be int32
    with pytest.raises(ValueError):
        raster_tiles(*bad, tiles_x)
    bad = list(args)
    bad[1] = bad[1][:, :-1]                         # x narrower than ok
    with pytest.raises(ValueError):
        raster_tiles(*bad, tiles_x)
    # the plain versions are what a CPU tensor gets
    out = raster_tiles(*args, tiles_x)
    ref = raster_tiles_reference(*args, tiles_x)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    d, s, r = raster_resolve_tiles(t(counts), t(pack), None, 2)
    d2, s2, _ = raster_resolve_tiles_reference(t(counts), t(pack), None, 2)
    assert r is None and torch.equal(d, d2) and torch.equal(s, s2)
