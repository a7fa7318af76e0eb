"""Tile rasterizer: vertex transform, near clip, setup, binning and the
visibility walk.

Counterpart of ``banggameengine_tpu/render/raster.py``: the same
functions, on the same component-form [T]/[S] planes, in the same f32 op
order.  The visibility pass is the count-adaptive walk
(:mod:`raster_walk`, a CUDA kernel on the GPU): on the GPU it takes the
place of the reference's XLA light/heavy tile scan, whose split exists to
fit the TPU.  The walk keeps only depth and slot per pixel ("slim"); the
shade recomputes barycentrics from ``TiledVisibility.sub_raster``.

Pixels are 32x128 tiles; depth is NDC z in [0, 1], 1.0 = background;
rendering is two-sided with a LESS depth test.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from banggameengine_tpu_torch.render import raster_walk as rwk
from banggameengine_tpu_torch.render.raster_walk import (
    TILE_H,
    TILE_W,
    pack_tile_triangles,
)

Tensor = torch.Tensor

# shared bin for triangles spanning many tiles (the ground plane class),
# walked by every tile
K_GLOBAL = 16
HEAVY_CAPACITY = 256   # local slots the walk covers per tile
WALK_CHUNK = 8         # the walk's rows are padded to a multiple of this


class VisibilityBuffer(NamedTuple):
    """Planar visibility buffer.  The walk is slim: ``tri_id``, ``b1`` and
    ``b2`` are None (the full carry is ROADMAP queue 2 #5)."""

    depth: Tensor           # f32[H,W], 1.0 = far/background
    tri_id: Tensor | None   # int32[H,W], -1 = background
    b1: Tensor | None       # f32[H,W]
    b2: Tensor | None       # f32[H,W]


@dataclasses.dataclass
class TiledVisibility:
    """Tile-major visibility planes + per-tile triangle lists, the input of
    the deferred shade's per-tile resolve.  ``slot`` indexes each pixel's
    winning sub-triangle within its tile's ``ids`` row (-1 = background).

    ``full_walk`` says that every tile was walked to the full width of
    ``ids``, so the shade's resolve must cover that width for every tile.
    (The JAX package marks this with an empty ``heavy`` array.)"""

    depth: Tensor        # f32[tiles, TH, TW]
    slot: Tensor         # int32[tiles, TH, TW]
    ids: Tensor          # int32[tiles, K] sub-triangle ids per tile, -1 pad
    sub_raster: Tensor   # f32[12, S] sx0..2, sy0..2, cb01, cb11, cb21,
    #                      cb02, cb12, cb22 per sub-triangle
    full_walk: bool


def transform_vertices(v_pos, v_entity, world_mats, view, proj):
    """Object-space vertices -> (world_pos f32[V,3], clip f32[V,4])."""
    w = world_mats[v_entity.to(torch.int64)]              # [V,4,4]
    wp = torch.einsum("vij,vj->vi", w[:, :3, :3], v_pos) + w[:, :3, 3]
    vp = torch.matmul(proj, view)
    wp4 = torch.cat([wp, torch.ones_like(wp[:, :1])], dim=-1)
    clip = torch.einsum("ij,vj->vi", vp, wp4)
    return wp, clip


def transform_normals(v_nrm, v_entity, normal_mats):
    nm = normal_mats[v_entity.to(torch.int64)]            # [V,3,3]
    n = torch.einsum("vij,vj->vi", nm, v_nrm)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True).clamp_min(
        1e-9)


def clip_near_plane(clip_tri: Tensor, tri_valid: Tensor):
    """Clip triangles against the near plane (clip-space z >= 0).

    Each triangle yields up to 2 sub-triangles whose corners carry their
    barycentric coordinates in the original triangle.
    clip_tri f32[T,3,4] -> (sub_clip f32[T,2,3,4], sub_bary f32[T,2,3,3],
    sub_valid bool[T,2])."""
    d_c = [clip_tri[:, i, 2] for i in range(3)]
    inside = [dc >= 0.0 for dc in d_c]
    k = (inside[0].to(torch.int32) + inside[1].to(torch.int32)
         + inside[2].to(torch.int32))                     # [T] 0..3

    # rotate so that: k == 1 -> the inside vertex is slot 0;
    #                 k == 2 -> the outside vertex is slot 2
    r1 = torch.where(inside[0], 0, torch.where(inside[1], 1, 2))
    r2f = torch.where(~inside[0], 0, torch.where(~inside[1], 1, 2))
    r2 = torch.remainder(r2f + 1, 3)
    r = torch.where(k == 1, r1, torch.where(k == 2, r2, 0))

    def rot(comps, s):
        a, b, c = comps[s % 3], comps[(s + 1) % 3], comps[(s + 2) % 3]
        return torch.where(r == 0, a, torch.where(r == 1, b, c))

    v_cols = [[clip_tri[:, i, j] for i in range(3)] for j in range(4)]
    vs = [[rot(v_cols[j], s) for j in range(4)] for s in range(3)]
    ds = [rot(d_c, s) for s in range(3)]
    bs = [[(torch.remainder(s + r, 3) == col).to(clip_tri.dtype)
           for col in range(3)] for s in range(3)]

    def safe_t(da, db):
        den = da - db
        return da / torch.where(den.abs() > 1e-12, den, 1e-12)

    t01 = safe_t(ds[0], ds[1])
    t02 = safe_t(ds[0], ds[2])
    t12 = safe_t(ds[1], ds[2])

    def lerp(a, b, t):
        return a + (b - a) * t

    i01 = [lerp(vs[0][j], vs[1][j], t01) for j in range(4)]
    i02 = [lerp(vs[0][j], vs[2][j], t02) for j in range(4)]
    i12 = [lerp(vs[1][j], vs[2][j], t12) for j in range(4)]
    bi01 = [lerp(bs[0][c], bs[1][c], t01) for c in range(3)]
    bi02 = [lerp(bs[0][c], bs[2][c], t02) for c in range(3)]
    bi12 = [lerp(bs[1][c], bs[2][c], t12) for c in range(3)]

    k2 = k == 2
    k3 = k == 3

    def pick(full, clip2, clip1):
        # k3 -> untouched; k2 -> two-in case; else one-in case
        return torch.where(k3, full, torch.where(k2, clip2, clip1))

    # sub-triangle 1: k3 -> (v0,v1,v2); k2 -> (v0,v1,i12); k1 -> (v0,i01,i02)
    s1 = [vs[0],
          [pick(vs[1][j], vs[1][j], i01[j]) for j in range(4)],
          [pick(vs[2][j], i12[j], i02[j]) for j in range(4)]]
    s1b = [bs[0],
           [pick(bs[1][c], bs[1][c], bi01[c]) for c in range(3)],
           [pick(bs[2][c], bi12[c], bi02[c]) for c in range(3)]]
    # sub-triangle 2: only k2 -> (v0, i12, i02)
    s2 = [vs[0], i12, i02]
    s2b = [bs[0], bi12, bi02]

    def asm(rows):
        # rows[corner][component] of [T] -> [T, 3, width]
        return torch.stack([torch.stack(rows[c], dim=-1) for c in range(3)],
                           dim=1)

    sub_clip = torch.stack([asm(s1), asm(s2)], dim=1)     # [T,2,3,4]
    sub_bary = torch.stack([asm(s1b), asm(s2b)], dim=1)   # [T,2,3,3]
    sub_valid = torch.stack([tri_valid & (k >= 1), tri_valid & k2], dim=1)
    return sub_clip, sub_bary, sub_valid


def setup_triangles(sub_clip: Tensor, sub_valid: Tensor, width: int,
                    height: int) -> dict:
    """Near-clipped sub-triangles f32[S,3,4] -> screen-space raster data:
    sx, sy, z, inv_w f32[S,3], area f32[S], bbox (x0, y0, x1, y1) and
    valid bool[S]."""
    ws = [sub_clip[:, i, 3] for i in range(3)]
    safe_w = [torch.where(w.abs() > 1e-9, w, 1e-9) for w in ws]
    iw = [1.0 / sw for sw in safe_w]
    # true divisions (not multiplications by the reciprocal), as the JAX
    # package computes them
    sx = [(sub_clip[:, i, 0] / safe_w[i] * 0.5 + 0.5) * width
          for i in range(3)]
    sy = [(1.0 - (sub_clip[:, i, 1] / safe_w[i] * 0.5 + 0.5)) * height
          for i in range(3)]
    z = [sub_clip[:, i, 2] / safe_w[i] for i in range(3)]

    in_front = (ws[0] > 1e-7) & (ws[1] > 1e-7) & (ws[2] > 1e-7)
    x0 = torch.minimum(torch.minimum(sx[0], sx[1]), sx[2])
    x1 = torch.maximum(torch.maximum(sx[0], sx[1]), sx[2])
    y0 = torch.minimum(torch.minimum(sy[0], sy[1]), sy[2])
    y1 = torch.maximum(torch.maximum(sy[0], sy[1]), sy[2])
    on_screen = (x1 >= 0) & (x0 < width) & (y1 >= 0) & (y0 < height)
    area = (sx[1] - sx[0]) * (sy[2] - sy[0]) - (sy[1] - sy[0]) * (
        sx[2] - sx[0])
    valid = sub_valid & in_front & on_screen & (area.abs() > 1e-9)
    return dict(
        sx=torch.stack(sx, dim=1), sy=torch.stack(sy, dim=1),
        z=torch.stack(z, dim=1), inv_w=torch.stack(iw, dim=1), area=area,
        bbox=(x0, y0, x1, y1), valid=valid,
    )


def _tile_index(v: Tensor, tile: int, n: int) -> Tensor:
    return torch.clamp(torch.floor(v / tile), 0, n - 1).to(torch.int64)


def bin_triangles(tri: dict, width: int, height: int, k_local: int = 256,
                  k_global: int = K_GLOBAL, span_x: int = 4,
                  span_y: int = 4):
    """Bbox-vs-tile binning.

    Small triangles (tile span <= span_x x span_y) emit one (tile, tri)
    pair per covered tile; one sort of the pair keys plus a rank within
    each tile's run builds the per-tile lists in ascending triangle order.
    Triangles spanning more tiles go to a shared global list (the first
    ``k_global`` in ascending order) prepended to every tile.

    Returns (ids int32[tiles, k_global + k_local] -1 padded, counts
    int32[tiles], local_counts int32[tiles] (global list excluded),
    overflow int32 (triangles dropped by either capacity),
    (tiles_y, tiles_x))."""
    device = tri["valid"].device
    tiles_x = (width + TILE_W - 1) // TILE_W
    tiles_y = (height + TILE_H - 1) // TILE_H
    n_tiles = tiles_x * tiles_y
    t = tri["valid"].shape[0]

    bx0, by0, bx1, by1 = tri["bbox"]
    tx0 = _tile_index(bx0, TILE_W, tiles_x)
    ty0 = _tile_index(by0, TILE_H, tiles_y)
    tx1 = _tile_index(bx1, TILE_W, tiles_x)
    ty1 = _tile_index(by1, TILE_H, tiles_y)
    span_w = tx1 - tx0 + 1
    span_h = ty1 - ty0 + 1
    is_local = tri["valid"] & (span_w <= span_x) & (span_h <= span_y)
    is_global = tri["valid"] & ~is_local

    # global list: the first k_global, in ascending order, by a running
    # count (stable compaction); the rest go to a dropped sink slot
    tri_ids = torch.arange(t, dtype=torch.int64, device=device)
    g_total = is_global.to(torch.int64).cumsum(0)
    g_count = g_total[-1]
    dest = torch.where(is_global & (g_total <= k_global), g_total - 1,
                       k_global)
    gids = torch.full((k_global + 1,), -1, dtype=torch.int64, device=device)
    gids = gids.scatter(0, dest, tri_ids)[:k_global].to(torch.int32)
    g_overflow = (g_count - k_global).clamp_min(0)

    # local pairs: tri x span slot -> tile id, keyed (tile, tri)
    n_span = span_x * span_y
    slot = torch.arange(n_span, device=device)
    dx = slot % span_x
    dy = slot // span_x
    tile_of = ((ty0[:, None] + dy[None, :]) * tiles_x
               + (tx0[:, None] + dx[None, :]))
    pair_ok = (is_local[:, None] & (dx[None, :] < span_w[:, None])
               & (dy[None, :] < span_h[:, None]))
    stride = 1 << max(t - 1, 1).bit_length()
    sentinel = n_tiles * stride                  # sorts after every real key
    key = torch.where(pair_ok, tile_of * stride + tri_ids[:, None], sentinel)
    key = torch.sort(key.reshape(-1)).values
    pk_tile = key // stride
    pk_tri = key % stride
    pk_ok = key != sentinel

    # each tile's run of the sorted keys starts at bounds[tile]: the rank
    # within the run is the distance from there (the JAX package finds the
    # run starts with a max-scan, which equals this and on the GPU costs
    # ~11 ms on the 10k-box frame's 3.8 M keys)
    bounds = torch.searchsorted(
        pk_tile, torch.arange(n_tiles + 1, device=device), side="left")
    rank = torch.arange(key.shape[0], device=device) - bounds[pk_tile]

    ok = pk_ok & (rank < k_local)
    # pairs beyond capacity (and the sentinels) land in a dropped sink row
    flat = torch.where(ok, pk_tile * k_local + rank, n_tiles * k_local)
    ids_local = torch.full(((n_tiles + 1) * k_local,), -1, dtype=torch.int32,
                           device=device)
    ids_local = ids_local.index_put(
        (flat,), torch.where(ok, pk_tri, -1).to(torch.int32))
    ids_local = ids_local.reshape(n_tiles + 1, k_local)[:n_tiles]
    local_counts = (bounds[1:] - bounds[:-1]).to(torch.int32)
    l_overflow = (local_counts - k_local).clamp_min(0).sum()

    ids = torch.cat([gids[None, :].expand(n_tiles, k_global), ids_local],
                    dim=1)
    counts = local_counts + torch.clamp_max(g_count, k_global).to(torch.int32)
    overflow = (g_overflow + l_overflow).to(torch.int32)
    return ids, counts, local_counts, overflow, (tiles_y, tiles_x)


def untile(a: Tensor, tiles_y: int, tiles_x: int, height: int,
           width: int) -> Tensor:
    """[tiles, TH, TW, ...] tile-major planes -> [height, width, ...]."""
    rest = a.shape[3:]
    a = a.reshape((tiles_y, tiles_x, TILE_H, TILE_W) + rest)
    a = a.transpose(1, 2).reshape((tiles_y * TILE_H, tiles_x * TILE_W) + rest)
    return a[:height, :width]


def rasterize(clip: Tensor, tri_valid: Tensor, width: int, height: int,
              bin_capacity: int = 2048, backend: str = "walk",
              return_tiled: bool = False, slim: bool = True):
    """Visibility pass: near clip, setup, binning and the walk.  The tile
    grid extends past the right and bottom edges; outputs are cropped.

    Returns (vis, overflow) or, with ``return_tiled=True``,
    (vis, overflow, tiled).  Every tile walks the global list plus its
    first ``HEAVY_CAPACITY`` local triangles; ``overflow`` counts every
    dropped triangle-tile pair once (the JAX walk route counts the pairs
    beyond ``bin_capacity`` twice).

    Only the walk is ported: ``backend`` other than "walk" raises
    NotImplementedError.  The walk keeps depth and slot only, so
    ``slim=False`` raises ValueError (the JAX walk silently ignores it)."""
    if backend != "walk":
        raise NotImplementedError(
            f"raster backend {backend!r} is not ported: on the GPU the walk "
            "replaces the XLA light/heavy scan (ROADMAP queue 2 #3), and the "
            "full-carry tile raster is ROADMAP queue 2 #5")
    if not slim:
        raise ValueError(
            "rasterize(backend='walk') keeps depth and slot only; slim=False "
            "needs the full-carry tile raster (ROADMAP queue 2 #5)")
    pad_w = (-width) % TILE_W
    pad_h = (-height) % TILE_H
    rw, rh = width + pad_w, height + pad_h

    t = clip.shape[0] // 3
    sub_clip, sub_bary, sub_valid = clip_near_plane(clip.reshape(t, 3, 4),
                                                    tri_valid)
    s = 2 * t
    sub_clip = sub_clip.reshape(s, 3, 4)
    sub_bary = sub_bary.reshape(s, 3, 3)
    sub_valid = sub_valid.reshape(s)

    # screen mapping at the true resolution; the tile grid extends past it
    tri = setup_triangles(sub_clip, sub_valid, width, height)
    k_local = min(bin_capacity, 2 * t)
    ids, _counts, local_counts, overflow, (tiles_y, tiles_x) = bin_triangles(
        tri, rw, rh, k_local=k_local)

    kw = min(K_GLOBAL + HEAVY_CAPACITY, ids.shape[1])
    ids = ids[:, :kw]
    tri_pack, _k_pad = pack_tile_triangles(ids, tri["sx"], tri["sy"],
                                           tri["z"], chunk=WALK_CHUNK)
    local_cap = kw - K_GLOBAL
    counts_walk = K_GLOBAL + torch.clamp_max(local_counts, local_cap)
    # bin_triangles counted the locals beyond k_local; count every local
    # dropped by the walk width (local_cap <= k_local) once instead
    overflow = (overflow
                - (local_counts - k_local).clamp_min(0).sum()
                + (local_counts - local_cap).clamp_min(0).sum()
                ).to(torch.int32)
    depth, slot = rwk.raster_walk(counts_walk.to(torch.int32), tri_pack,
                                  tiles_x)
    zb = depth.reshape(-1, TILE_H, TILE_W)
    vis = VisibilityBuffer(depth=untile(zb, tiles_y, tiles_x, height, width),
                           tri_id=None, b1=None, b2=None)
    if not return_tiled:
        return vis, overflow
    sx, sy, cb = tri["sx"], tri["sy"], sub_bary
    sub_raster = torch.stack([
        sx[:, 0], sx[:, 1], sx[:, 2],
        sy[:, 0], sy[:, 1], sy[:, 2],
        cb[:, 0, 1], cb[:, 1, 1], cb[:, 2, 1],
        cb[:, 0, 2], cb[:, 1, 2], cb[:, 2, 2],
    ])                                                   # [12, S]
    tiled = TiledVisibility(depth=zb, slot=slot.reshape(-1, TILE_H, TILE_W),
                            ids=ids, sub_raster=sub_raster, full_walk=True)
    return vis, overflow, tiled
