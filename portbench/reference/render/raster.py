"""Tile rasterizer: vertex transform, near clip, setup, binning and the
visibility pass.

Counterpart of ``banggameengine_tpu/render/raster.py``: the same
functions, on the same component-form [T]/[S] planes, in the same f32 op
order.  Two visibility routes:

- the count-adaptive walk (:mod:`raster_walk`, a CUDA kernel on the GPU),
  the default: on the GPU it takes the place of the reference's XLA
  light/heavy tile scan.  It keeps only depth and slot per pixel ("slim");
  the tiled shade recomputes barycentrics from
  ``TiledVisibility.sub_raster``, and the fused shade walks the same
  :class:`FusedRasterPrep` inside its own kernel;
- the light/heavy full-carry raster (:mod:`raster_tile`, a CUDA kernel on
  the GPU, ``backend="tile"``), which also keeps each pixel's original
  triangle id and barycentrics for the flat gather shade.

Pixels are 32x128 tiles; depth is NDC z in [0, 1], 1.0 = background;
rendering is two-sided with a LESS depth test.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from portbench.reference.render import raster_tile as rt
from portbench.reference.render import raster_walk as rwk
from portbench.reference.render.raster_walk import (
    TILE_H,
    TILE_W,
    pack_tile_triangles,
)

Tensor = torch.Tensor

# shared bin for triangles spanning many tiles (the ground plane class),
# walked by every tile
K_GLOBAL = 16
HEAVY_CAPACITY = 256   # local slots the walk (and the heavy pass) covers
WALK_CHUNK = 8         # slot lists are padded to a multiple of this
LIGHT_CAPACITY = 48    # local slots the full-carry light pass covers
HEAVY_TILES = 64       # tiles the full-carry heavy pass re-rasters


class VisibilityBuffer(NamedTuple):
    """Planar visibility buffer.  The walk is slim: ``tri_id``, ``b1`` and
    ``b2`` are None; the full-carry raster fills them."""

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
    (The JAX package marks this with an empty ``heavy`` array.)  The
    full-carry raster's light/heavy planes are not a full walk."""

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


class _Binned(NamedTuple):
    """The front end of every raster route: near-clipped, set-up and binned
    sub-triangles of one frame."""

    tri: dict             # setup_triangles of the S = 2T sub-triangles
    sub_bary: Tensor      # f32[S, 3, 3] original-space corner barycentrics
    ids: Tensor           # int32[tiles, K_GLOBAL + k_local], -1 padded
    local_counts: Tensor  # int32[tiles]
    overflow: Tensor      # the binner's dropped pairs
    k_local: int
    tiles_y: int
    tiles_x: int


def _bin_frame(clip: Tensor, tri_valid: Tensor, width: int, height: int,
               bin_capacity: int) -> _Binned:
    """Near clip, setup and binning.  The screen mapping uses the true
    resolution; the tile grid extends past the right and bottom edges."""
    t = clip.shape[0] // 3
    sub_clip, sub_bary, sub_valid = clip_near_plane(clip.reshape(t, 3, 4),
                                                    tri_valid)
    tri = setup_triangles(sub_clip.reshape(2 * t, 3, 4),
                          sub_valid.reshape(2 * t), width, height)
    k_local = min(bin_capacity, 2 * t)
    ids, _counts, local_counts, overflow, (tiles_y, tiles_x) = bin_triangles(
        tri, width + (-width) % TILE_W, height + (-height) % TILE_H,
        k_local=k_local)
    return _Binned(tri, sub_bary.reshape(2 * t, 3, 3), ids, local_counts,
                   overflow, k_local, tiles_y, tiles_x)


def _overflow_once(binned: _Binned, local_walked) -> Tensor:
    """Dropped triangle-tile pairs, each counted once: the binner's (the
    globals beyond K_GLOBAL, the locals beyond k_local) with its locals
    replaced by those beyond the ``local_walked`` slots each tile's raster
    covered (<= k_local; an int or int[tiles])."""
    local = binned.local_counts
    return (binned.overflow
            - (local - binned.k_local).clamp_min(0).sum()
            + (local - local_walked).clamp_min(0).sum()).to(torch.int32)


def _sub_raster(tri: dict, sub_bary: Tensor) -> Tensor:
    """Per-sub-triangle screen rows f32[12, S]: sx0..2, sy0..2, cb01, cb11,
    cb21, cb02, cb12, cb22 (the shade recomputes barycentrics from them)."""
    sx, sy, cb = tri["sx"], tri["sy"], sub_bary
    return torch.stack([
        sx[:, 0], sx[:, 1], sx[:, 2],
        sy[:, 0], sy[:, 1], sy[:, 2],
        cb[:, 0, 1], cb[:, 1, 1], cb[:, 2, 1],
        cb[:, 0, 2], cb[:, 1, 2], cb[:, 2, 2],
    ])


class FusedRasterPrep(NamedTuple):
    """The walk's inputs for one frame: binned and packed per-tile rows.
    The fused shade joins the resolve tables to them at the kernel call;
    the walk route walks them alone."""

    tri_pack: Tensor     # f32[tiles, K_pad, PACK_CH]
    counts_walk: Tensor  # int32[tiles] slots to walk (global + local)
    ids_w: Tensor        # int32[tiles, KW] binned ids at the walk width
    sub_raster: Tensor   # f32[12, S] per-sub-triangle screen rows
    overflow: Tensor     # int32 dropped triangle-tile pairs, counted once
    tiles_x: int
    tiles_y: int


def prepare_fused_raster(clip: Tensor, tri_valid: Tensor, width: int,
                         height: int,
                         bin_capacity: int = 2048) -> FusedRasterPrep:
    """Near clip, setup, binning and packing for the walk: every tile walks
    the global list plus its first ``HEAVY_CAPACITY`` local triangles,
    predicated on its own count.  ``overflow`` counts every dropped
    triangle-tile pair once (the JAX package counts the locals beyond
    ``bin_capacity`` twice)."""
    b = _bin_frame(clip, tri_valid, width, height, bin_capacity)
    kw = min(K_GLOBAL + HEAVY_CAPACITY, b.ids.shape[1])
    ids_w = b.ids[:, :kw]
    tri_pack, _k_pad = pack_tile_triangles(ids_w, b.tri["sx"], b.tri["sy"],
                                           b.tri["z"], chunk=WALK_CHUNK)
    local_cap = kw - K_GLOBAL
    counts_walk = (K_GLOBAL + torch.clamp_max(b.local_counts, local_cap)
                   ).to(torch.int32)
    return FusedRasterPrep(tri_pack, counts_walk, ids_w,
                           _sub_raster(b.tri, b.sub_bary),
                           _overflow_once(b, local_cap), b.tiles_x,
                           b.tiles_y)


def _gathered(b: _Binned, sel_ids: Tensor) -> tuple:
    """The full-carry raster's per-slot inputs for the tiles of ``sel_ids``
    int32[n, K]: (x, y, z, oid, cb1, cb2, ok)."""
    safe = sel_ids.clamp_min(0).to(torch.int64)
    cb = b.sub_bary[safe]                                  # [n, K, 3, 3]
    return (b.tri["sx"][safe], b.tri["sy"][safe], b.tri["z"][safe],
            (safe // 2).to(torch.int32), cb[..., 1], cb[..., 2],
            (sel_ids >= 0).to(torch.int32))


def _light_pass(b: _Binned) -> tuple:
    """The light pass's arguments of :func:`raster_tile.raster_tiles`:
    every tile, with the global list and its first ``LIGHT_CAPACITY``
    locals."""
    kl = min(K_GLOBAL + LIGHT_CAPACITY, b.ids.shape[1])
    all_tiles = torch.arange(b.ids.shape[0], dtype=torch.int32,
                             device=b.ids.device)
    return (all_tiles, *_gathered(b, b.ids[:, :kl]), b.tiles_x)


def _heavy_pass(b: _Binned) -> tuple:
    """The heavy pass's arguments of :func:`raster_tile.raster_tiles`: the
    ``HEAVY_TILES`` tiles with the most locals, in a stable descending
    order (lower tile index first among equal counts, as ``lax.top_k``),
    with the global list and their first ``HEAVY_CAPACITY`` locals."""
    heavy = torch.sort(b.local_counts, descending=True,
                       stable=True).indices[:HEAVY_TILES]
    kh = min(K_GLOBAL + HEAVY_CAPACITY, b.ids.shape[1])
    return (heavy.to(torch.int32), *_gathered(b, b.ids[heavy, :kh]),
            b.tiles_x)


def _raster_full_carry(b: _Binned):
    """The light/heavy full-carry raster (the JAX package's ``"pallas"``
    backend): every tile rasters the global list and its first
    ``LIGHT_CAPACITY`` locals; the ``HEAVY_TILES`` tiles with the most
    locals (:func:`_heavy_pass`) are rastered again at
    ``HEAVY_CAPACITY`` locals, and their results replace the light ones
    where they hold more than ``LIGHT_CAPACITY``.  The heavy pass always
    runs, so no host synchronisation decides it.

    Returns the planes (depth, tri_id, b1, b2, slot), each [tiles, 32,
    128], and the locals each tile's raster covered, int[tiles]."""
    kl = min(K_GLOBAL + LIGHT_CAPACITY, b.ids.shape[1])
    light_cap = kl - K_GLOBAL
    planes = rt.raster_tiles(*_light_pass(b))
    covered = torch.full_like(b.local_counts, light_cap)
    if b.ids.shape[1] > kl:
        args = _heavy_pass(b)
        heavy = args[0].long()
        needs = b.local_counts[heavy] > light_cap
        kh = args[1].shape[1]
        outs = rt.raster_tiles(*args)
        keep = needs[:, None, None]
        planes = tuple(p.index_copy(0, heavy, torch.where(keep, o, p[heavy]))
                       for p, o in zip(planes, outs))
        covered = covered.index_copy(
            0, heavy, torch.where(needs, kh - K_GLOBAL, light_cap).to(
                covered.dtype))
    return planes, covered


def rasterize(clip: Tensor, tri_valid: Tensor, width: int, height: int,
              bin_capacity: int = 2048, backend: str = "walk",
              return_tiled: bool = False, slim: bool = True):
    """Visibility pass: near clip, setup, binning and a raster route.
    Outputs are cropped to width x height.

    Returns (vis, overflow) or, with ``return_tiled=True``,
    (vis, overflow, tiled).  ``overflow`` counts every dropped
    triangle-tile pair once (the JAX package counts the locals beyond
    ``bin_capacity`` twice).  Routes:

    - ``"walk"`` (the default): every tile walks the global list plus its
      first ``HEAVY_CAPACITY`` locals (:mod:`raster_walk`).  It keeps depth
      and slot only: ``vis`` has no ``tri_id``/``b1``/``b2``, and
      ``slim=False`` raises ValueError (the JAX walk silently ignores it).
    - ``"tile"``: the light/heavy full-carry raster (:mod:`raster_tile`,
      the JAX package's ``"pallas"`` backend; see :func:`_raster_full_carry`)
      with all four planes of ``vis`` whatever ``slim`` says.  Its
      ``tiled`` is not a full walk (``full_walk=False``).

    Other backends raise ValueError."""
    if backend not in ("walk", "tile"):
        raise ValueError(
            f"raster backend {backend!r} is not the port's: on the GPU the "
            "walk replaces the XLA light/heavy scan, and 'tile' is the "
            "full-carry raster of the JAX package's 'pallas' (ROADMAP "
            "'Not to port')")
    if backend == "walk" and not slim:
        raise ValueError(
            "rasterize(backend='walk') keeps depth and slot only; slim=False "
            "needs the full-carry raster, backend='tile'")
    if backend == "walk":
        prep = prepare_fused_raster(clip, tri_valid, width, height,
                                    bin_capacity)
        tiles_y, tiles_x = prep.tiles_y, prep.tiles_x
        depth, slot = rwk.raster_walk(prep.counts_walk, prep.tri_pack,
                                      tiles_x)
        zb = depth.reshape(-1, TILE_H, TILE_W)
        slot = slot.reshape(-1, TILE_H, TILE_W)
        vis = VisibilityBuffer(
            depth=untile(zb, tiles_y, tiles_x, height, width), tri_id=None,
            b1=None, b2=None)
        overflow, ids, sub_raster = prep.overflow, prep.ids_w, prep.sub_raster
    else:
        b = _bin_frame(clip, tri_valid, width, height, bin_capacity)
        tiles_y, tiles_x = b.tiles_y, b.tiles_x
        (zb, tid, b1, b2, slot), covered = _raster_full_carry(b)
        vis = VisibilityBuffer(*(untile(a, tiles_y, tiles_x, height, width)
                                 for a in (zb, tid, b1, b2)))
        overflow = _overflow_once(b, covered)
        ids = b.ids
        sub_raster = _sub_raster(b.tri, b.sub_bary) if return_tiled else None
    if not return_tiled:
        return vis, overflow
    tiled = TiledVisibility(depth=zb, slot=slot, ids=ids,
                            sub_raster=sub_raster,
                            full_walk=backend == "walk")
    return vis, overflow, tiled
