"""Deferred Blinn-Phong shading of the tiled visibility buffer.

Counterpart of ``banggameengine_tpu/render/shading.py``: the reference's
fragment shader ``fs_basic``

    N = normalize(worldNormal); L = normalize(-lightDir)
    V = normalize(cameraPos - worldPos); H = normalize(L + V)
    rgb = tex.rgb * baseTint.rgb * (ambient + lightColor * max(dot(N, L), 0))
          + specColor * pow(max(dot(N, H), 0), shininess) * specIntensity

with the renderer's global shininess and spec intensity over the
material's, and the 0x88AAFF sky clear.  The world position is unprojected
from the depth plane.  Three shades, one core:

- :func:`shade_visibility_tiled`: each pixel's attributes come from its
  tile's table through the resolve (:mod:`resolve`, a CUDA kernel on the
  GPU) of the raster's slots, the walk's or the light/heavy full-carry
  raster's; winners beyond the resolved width take a row gather; the
  barycentrics are recomputed per pixel from the winning sub-triangle's
  screen rows;
- :func:`shade_visibility_fused`: the same, with the walk and the resolve
  in one kernel (:mod:`raster_resolve`);
- :func:`shade_visibility`: the flat gather shade of the full-carry
  raster's planes, one row gather per pixel by its triangle id.

The first two run on tile-major [tiles, px] planes and untile only the
final u8 image.  The JAX package's XLA one-hot resolve is not ported: the
resolve kernel computes its function (ROADMAP "Not to port").  The two
bilinear samplers of u8 texture pages (:func:`sample_texture_bilinear`,
:func:`sample_texture_bilinear_quad`) are the JAX package's, for callers
that sample a pixel's texture by uv; the shades sample the channel-major
texel-quad pack instead.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference import math3d
from portbench.reference.render import raster_resolve as rr
from portbench.reference.render import resolve as rsv
from portbench.reference.render.raster import (
    TILE_H,
    TILE_W,
    FusedRasterPrep,
    TiledVisibility,
    untile,
)
from portbench.reference.render.raster_walk import pixel_centres

Tensor = torch.Tensor

CLEAR_COLOR = (0x88 / 255.0, 0xAA / 255.0, 0xFF / 255.0)


@dataclasses.dataclass
class LightParams:
    """Directional light + global material overrides."""

    yaw: Tensor            # f32[]
    pitch: Tensor          # f32[]
    color: Tensor          # f32[3]
    ambient: Tensor        # f32[]
    shininess: Tensor      # f32[] global override
    spec_intensity: Tensor  # f32[] global override

    @staticmethod
    def default(device: torch.device | str = "cuda") -> "LightParams":
        # filled on the device: a copy from the host would synchronise
        def f32(v, shape=()):
            return torch.full(shape, v, dtype=torch.float32, device=device)

        return LightParams(yaw=f32(0.0), pitch=f32(0.0),
                           color=f32(1.0, (3,)), ambient=f32(0.5),
                           shininess=f32(32.0), spec_intensity=f32(0.35))

    def direction(self) -> Tensor:
        cy, sy = torch.cos(self.yaw), torch.sin(self.yaw)
        cp, sp = torch.cos(self.pitch), torch.sin(self.pitch)
        return torch.stack([cy * cp, sp, sy * cp])


def _wrap(i: Tensor, n: Tensor) -> Tensor:
    """Repeat wrap of texel index ``i`` into [0, n): a floor modulo of the
    int32 index by max(n, 1)."""
    return torch.remainder(i.to(torch.int32), n.to(torch.int32).clamp_min(1))


def _bilinear_taps(tex_size: Tensor, tex_id: Tensor, uv: Tensor):
    """(x0, y0 as float, the texel weights tx, ty, w, h) of bilinear sampling
    with texel centres at +0.5."""
    wh = tex_size[tex_id.to(torch.int64)].to(torch.float32)
    w, h = wh[..., 0], wh[..., 1]
    fx = uv[..., 0] * w - 0.5
    fy = uv[..., 1] * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    return x0, y0, fx - x0, fy - y0, w, h


def _lerp2(c00, c01, c10, c11, tx, ty):
    top = c00 + (c01 - c00) * tx[..., None]
    bot = c10 + (c11 - c10) * tx[..., None]
    return top + (bot - top) * ty[..., None]


def sample_texture_bilinear(textures: Tensor, tex_size: Tensor,
                            tex_id: Tensor, uv: Tensor) -> Tensor:
    """Bilinear, wrap-repeat texture sampling: ``textures`` u8[T, S, S, 4]
    (square pages), ``tex_size`` int32[T, 2] each page's (w, h), ``tex_id``
    int[...], ``uv`` f32[..., 2] -> f32[..., 4] in [0, 1].  Four fetches,
    (y0, x0), (y0, x1), (y1, x0), (y1, x1)."""
    x0, y0, tx, ty, w, h = _bilinear_taps(tex_size, tex_id, uv)
    x0i, x1i = _wrap(x0, w), _wrap(x0 + 1, w)
    y0i, y1i = _wrap(y0, h), _wrap(y0 + 1, h)
    t = tex_id.to(torch.int64)

    def fetch(yi, xi):
        return textures[t, yi.to(torch.int64), xi.to(torch.int64)].to(
            torch.float32) / 255.0

    return _lerp2(fetch(y0i, x0i), fetch(y0i, x1i), fetch(y1i, x0i),
                  fetch(y1i, x1i), tx, ty)


def sample_texture_bilinear_quad(textures_quad: Tensor, tex_size: Tensor,
                                 tex_id: Tensor, uv: Tensor) -> Tensor:
    """:func:`sample_texture_bilinear` with one fetch a pixel:
    ``textures_quad`` u8[T, S, S, 16] packs each texel's wrapped 2x2
    neighbourhood (``RenderScene.textures_quad``)."""
    x0, y0, tx, ty, w, h = _bilinear_taps(tex_size, tex_id, uv)
    quad = textures_quad[tex_id.to(torch.int64),
                         _wrap(y0, h).to(torch.int64),
                         _wrap(x0, w).to(torch.int64)].to(torch.float32)
    quad = quad / 255.0
    return _lerp2(quad[..., 0:4], quad[..., 4:8], quad[..., 8:12],
                  quad[..., 12:16], tx, ty)


# channels of the per-triangle table (reconstructed world position):
# 0..17 three corners x (nrm.xyz, u, v in texels, inv_w), 18..21 tint rgba,
# 22..24 spec color, 25 texture id, 26..27 texture (w, h)
_SPAN, _UVO, _M_TINT, _M_SPEC, _M_TEX, _M_TW = 6, 3, 18, 22, 25, 26


def _pack_tri_rows(world_nrm, v_uv, inv_w, tri_material, mat_base_tint,
                   mat_uv_scale, mat_spec_color, mat_tex, tex_size) -> Tensor:
    """Per-triangle channel-major table f32[28, T].  uv is pre-scaled to
    texel units per corner (material uv scale times texture size)."""
    mat_twh = tex_size[mat_tex.to(torch.int64)].to(torch.float32)   # [M,2]
    t = tri_material.shape[0]
    mat_idx = tri_material.to(torch.int64)
    uv_texel = (v_uv.reshape(t, 3, 2)
                * (mat_uv_scale * mat_twh)[mat_idx][:, None, :]
                ).reshape(t * 3, 2)
    packed_tri = torch.cat([world_nrm, uv_texel, inv_w[:, None]],
                           dim=-1).reshape(-1, 18)
    mat_packed = torch.cat([mat_base_tint, mat_spec_color,
                            mat_tex[:, None].to(torch.float32), mat_twh],
                           dim=-1)                                   # [M,10]
    return torch.cat([packed_tri, mat_packed[mat_idx]], dim=-1).T


def _sample_bilinear_planar(textures, textures_quad_t, tex_id, tw, th, u, v):
    """Bilinear, wrap-repeat sampling from the channel-major texel-quad pack
    u8[16, T*S*S]: one gather brings all four taps.  u/v are in texel
    units; returns four f32 channel planes."""
    fx = u - 0.5
    fy = v - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = fx - x0
    ty = fy - y0

    s = textures.shape[1]
    flat = (tex_id * s + _wrap(y0, th)) * s + _wrap(x0, tw)
    q = textures_quad_t[:, flat.reshape(-1).to(torch.int64)].reshape(
        (16,) + flat.shape)

    def channel(c):
        c00, c01 = q[c].to(torch.float32), q[c + 4].to(torch.float32)
        c10, c11 = q[c + 8].to(torch.float32), q[c + 12].to(torch.float32)
        top = c00 + (c01 - c00) * tx
        bot = c10 + (c11 - c10) * tx
        return (top + (bot - top) * ty) * (1.0 / 255.0)

    return channel(0), channel(1), channel(2), channel(3)


def _shade_core(get, b1, b2, pxc, pyc, ndc_z, background, width, height,
                view, proj, textures, textures_quad_t, camera_pos, light,
                wireframe=False):
    """Component-form shading of every pixel.  ``get(c)`` returns the
    pixel's channel ``c`` of the triangle table.  ``wireframe`` keeps
    only the pixels near a triangle edge (the smallest barycentric under
    0.05) and clears the rest.  Returns (r, g, b, a)."""
    b0 = 1.0 - b1 - b2
    w0 = b0 * get(_SPAN - 1)
    w1 = b1 * get(2 * _SPAN - 1)
    w2 = b2 * get(3 * _SPAN - 1)
    persp_den = w0 + w1 + w2
    inv_den = 1.0 / torch.where(persp_den.abs() > 1e-12, persp_den, 1e-12)

    def interp(c):
        """Perspective-correct interpolation of per-corner channel c."""
        return (get(c) * w0 + get(c + _SPAN) * w1
                + get(c + 2 * _SPAN) * w2) * inv_den

    # unproject (ndc_x, ndc_y, ndc_z, 1) through inv(proj @ view)
    m = math3d.inverse(torch.matmul(proj, view))
    ndc_x = pxc * (2.0 / width) - 1.0
    ndc_y = 1.0 - pyc * (2.0 / height)
    hx, hy, hz, hw = (m[i, 0] * ndc_x + m[i, 1] * ndc_y + m[i, 2] * ndc_z
                      + m[i, 3] for i in range(4))
    inv_hw = 1.0 / torch.where(hw.abs() > 1e-12, hw, 1e-12)
    wpx, wpy, wpz = hx * inv_hw, hy * inv_hw, hz * inv_hw
    nx, ny, nz = interp(0), interp(1), interp(2)
    u = interp(_UVO)
    v = interp(_UVO + 1)

    tint = [get(_M_TINT + i) for i in range(4)]
    spec = [get(_M_SPEC + i) for i in range(3)]
    tex_id = get(_M_TEX).to(torch.int32)
    tex_r, tex_g, tex_b, tex_a = _sample_bilinear_planar(
        textures, textures_quad_t, tex_id, get(_M_TW), get(_M_TW + 1), u, v)

    inv_nlen = torch.rsqrt((nx * nx + ny * ny + nz * nz).clamp_min(1e-18))
    nx, ny, nz = nx * inv_nlen, ny * inv_nlen, nz * inv_nlen

    ld = -light.direction()
    ld = ld / torch.linalg.vector_norm(ld).clamp_min(1e-9)
    lx, ly, lz = ld[0], ld[1], ld[2]

    vx = camera_pos[0] - wpx
    vy = camera_pos[1] - wpy
    vz = camera_pos[2] - wpz
    inv_vlen = torch.rsqrt((vx * vx + vy * vy + vz * vz).clamp_min(1e-18))
    vx, vy, vz = vx * inv_vlen, vy * inv_vlen, vz * inv_vlen

    hx, hy, hz = lx + vx, ly + vy, lz + vz
    inv_hlen = torch.rsqrt((hx * hx + hy * hy + hz * hz).clamp_min(1e-18))
    hx, hy, hz = hx * inv_hlen, hy * inv_hlen, hz * inv_hlen

    diff = (nx * lx + ny * ly + nz * lz).clamp_min(0.0)
    ndoth = (nx * hx + ny * hy + nz * hz).clamp_min(0.0)
    # the global overrides replace the per-material shininess/intensity
    s = torch.pow(ndoth, light.shininess) * light.spec_intensity

    rgb = [tex * tint[i] * (light.ambient + light.color[i] * diff)
           + spec[i] * s
           for i, tex in enumerate((tex_r, tex_g, tex_b))]  # white vertices
    alpha = tex_a * tint[3]
    if wireframe:
        on_edge = torch.minimum(torch.minimum(b0, b1), b2) < 0.05
        rgb = [torch.where(on_edge, c, CLEAR_COLOR[i])
               for i, c in enumerate(rgb)]
    rgb = [torch.where(background, CLEAR_COLOR[i], c)
           for i, c in enumerate(rgb)]
    alpha = torch.where(background, 1.0, alpha)
    return rgb[0], rgb[1], rgb[2], alpha


def _to_u8(x: Tensor) -> Tensor:
    return (x.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def shade_visibility(
    vis_tri_id: Tensor, vis_b1: Tensor, vis_b2: Tensor,
    # per-vertex attributes (V = 3*T)
    world_nrm: Tensor, v_uv: Tensor, inv_w: Tensor, tri_material: Tensor,
    # material and texture tables
    mat_base_tint: Tensor, mat_uv_scale: Tensor, mat_spec_color: Tensor,
    mat_tex: Tensor, textures: Tensor, tex_size: Tensor,
    textures_quad_t: Tensor,
    camera_pos: Tensor, light: LightParams,
    vis_depth: Tensor, view: Tensor, proj: Tensor,
    wireframe: bool = False,
) -> Tensor:
    """Flat deferred shade of the full-carry planes [H, W] -> u8[H, W, 4]:
    one channel-major row gather of the triangle table per pixel, by its
    triangle id.  World positions come from ``vis_depth`` (the JAX
    package's ``reconstruct_wp`` form) and shininess from ``light``, so the
    JAX signature's ``world_pos`` and ``mat_spec_params`` are not taken."""
    h, w = vis_tri_id.shape
    tri_row_t = _pack_tri_rows(world_nrm, v_uv, inv_w, tri_material,
                               mat_base_tint, mat_uv_scale, mat_spec_color,
                               mat_tex, tex_size)                     # [28, T]
    tid = vis_tri_id.clamp_min(0).reshape(-1).to(torch.int64)
    a = tri_row_t[:, tid].reshape(-1, h, w)                # [28, H, W]
    device = vis_tri_id.device
    pyc = torch.arange(h, device=device, dtype=torch.float32)[:, None] + 0.5
    pxc = torch.arange(w, device=device, dtype=torch.float32)[None, :] + 0.5
    rgba = _shade_core(lambda c: a[c], vis_b1, vis_b2, pxc.expand(h, w),
                       pyc.expand(h, w), vis_depth, vis_tri_id < 0, w, h,
                       view, proj, textures, textures_quad_t, camera_pos,
                       light, wireframe)
    return torch.stack([_to_u8(c) for c in rgba], dim=-1)


def _sub_rows(tri_row_t: Tensor, sub_raster: Tensor) -> Tensor:
    """Per-sub-triangle channels f32[40, S]: its triangle's 28 (the same
    for both near-clip subs), then its 12 screen-space raster rows."""
    return torch.cat([torch.repeat_interleave(tri_row_t, 2, dim=1),
                      sub_raster], dim=0)


def _tile_tables(sub_row_t: Tensor, ids: Tensor) -> Tensor:
    """Per-tile resolve tables f32[tiles, 40, K] of the sub-triangles
    listed in ``ids`` int32[tiles, K]."""
    ids_w = ids.clamp_min(0).to(torch.int64)
    return sub_row_t.T[ids_w].transpose(1, 2).contiguous()


def _shade_tiled_tail(planes: Tensor, slot_p: Tensor, ndc_z: Tensor,
                      rb: int, tiles_y: int, tiles_x: int, width: int,
                      height: int, textures: Tensor, textures_quad_t: Tensor,
                      camera_pos: Tensor, light: LightParams, view: Tensor,
                      proj: Tensor, wireframe: bool = False) -> Tensor:
    """The tile-major shade both tiled shades share: the winning
    sub-triangle's barycentrics recomputed from its resolved raster rows at
    ``rb`` (in the raster's op order, then mapped to the original
    triangle), the shading core and the u8 untile.  ``planes`` is the
    resolved f32[C, tiles, px], ``slot_p`` and ``ndc_z`` [tiles, px]."""
    n_tiles = slot_p.shape[0]

    def get(c):
        return planes[c]

    pxc, pyc = pixel_centres(torch.arange(n_tiles, device=slot_p.device),
                             tiles_x)                        # [tiles, px]
    sx0, sx1, sx2 = get(rb), get(rb + 1), get(rb + 2)
    sy0, sy1, sy2 = get(rb + 3), get(rb + 4), get(rb + 5)
    e0 = (sx1 - sx0) * (pyc - sy0) - (sy1 - sy0) * (pxc - sx0)
    e2 = (sx0 - sx2) * (pyc - sy2) - (sy0 - sy2) * (pxc - sx2)
    area = (sx1 - sx0) * (sy2 - sy0) - (sy1 - sy0) * (sx2 - sx0)
    inv_area = 1.0 / torch.where(area.abs() > 1e-9, area, 1e-9)
    sb1 = e2 * inv_area
    sb2 = e0 * inv_area
    sb0 = 1.0 - sb1 - sb2
    b1 = sb0 * get(rb + 6) + sb1 * get(rb + 7) + sb2 * get(rb + 8)
    b2 = sb0 * get(rb + 9) + sb1 * get(rb + 10) + sb2 * get(rb + 11)

    rgba = _shade_core(get, b1, b2, pxc, pyc, ndc_z, slot_p < 0, width,
                       height, view, proj, textures, textures_quad_t,
                       camera_pos, light, wireframe)
    out = torch.stack([_to_u8(c) for c in rgba], dim=-1)    # [tiles, px, 4]
    return untile(out.reshape(n_tiles, TILE_H, TILE_W, 4), tiles_y, tiles_x,
                  height, width)


def tiled_resolve_width(tiled: TiledVisibility, shade_slots: int,
                        heavy_shade_slots: int) -> int:
    """The slots the tiled shade resolves through the per-tile tables: the
    full width of ``tiled.ids`` for a full walk, else the wider of
    ``shade_slots`` and ``heavy_shade_slots`` (the JAX shade's resolve
    width over the light/heavy raster, ``shading.py:487-492``), at most
    the list's width.  Winners at or beyond it take the row gather."""
    width = tiled.ids.shape[1]
    if tiled.full_walk:
        return width
    return min(max(shade_slots, heavy_shade_slots), width)


def shade_visibility_tiled(
    tiled: TiledVisibility,
    width: int, height: int,
    # per-vertex attributes (V = 3*T)
    world_nrm: Tensor, v_uv: Tensor, inv_w: Tensor, tri_material: Tensor,
    # material and texture tables
    mat_base_tint: Tensor, mat_uv_scale: Tensor, mat_spec_color: Tensor,
    mat_tex: Tensor, textures: Tensor, tex_size: Tensor,
    textures_quad_t: Tensor,
    camera_pos: Tensor, light: LightParams,
    view: Tensor, proj: Tensor,
    shade_slots: int = 64,
    heavy_shade_slots: int = 0,
    raster_max_slots: int | None = None,
    wireframe: bool = False,
) -> Tensor:
    """Tile-major deferred shade -> u8[H, W, 4].

    The per-tile resolve covers :func:`tiled_resolve_width` slots: every
    slot of a full walk (``tiled.full_walk``, which walked every tile to
    the list's width), else the wider of ``shade_slots`` and
    ``heavy_shade_slots``.  Winners at or beyond that width (the
    light/heavy raster's heavy tiles, when the widths understate its walk)
    take a row gather of their sub-triangle's channels instead, selected
    per pixel with no host synchronisation.  Where the resolve reaches the
    raster's slot ceiling (``raster_max_slots``, at most the list's
    width), no winner can lie beyond it and the gather is skipped.  World
    positions come from the depth plane and shininess from ``light``, so
    the JAX signature's ``world_pos`` and ``mat_spec_params`` are not
    taken."""
    n_tiles = tiled.slot.shape[0]
    tiles_x = -(-width // TILE_W)
    tri_row_t = _pack_tri_rows(world_nrm, v_uv, inv_w, tri_material,
                               mat_base_tint, mat_uv_scale, mat_spec_color,
                               mat_tex, tex_size)                     # [28, T]
    sub_row_t = _sub_rows(tri_row_t, tiled.sub_raster)               # [40, S]
    covered = tiled_resolve_width(tiled, shade_slots, heavy_shade_slots)
    tables = _tile_tables(sub_row_t, tiled.ids[:, :covered])
    slot_p = tiled.slot.reshape(n_tiles, -1)
    planes = rsv.resolve_tiles_wide(slot_p, tables)          # [40, t, px]
    ceiling = tiled.ids.shape[1]
    if raster_max_slots is not None:
        ceiling = min(raster_max_slots, ceiling)
    if covered < ceiling:
        # the row-gather fallback: every pixel gathers (its sub-triangle's
        # row where it needs one, row 0 elsewhere) and a select keeps it
        # only where the resolve could not reach
        need_fb = slot_p >= covered
        sid = torch.gather(tiled.ids, 1, slot_p.clamp_min(0).to(torch.int64))
        rows = sub_row_t[:, torch.where(need_fb, sid, 0).to(torch.int64)]
        planes = torch.where(need_fb, rows, planes)
    return _shade_tiled_tail(planes, slot_p, tiled.depth.reshape(n_tiles, -1),
                             tri_row_t.shape[0], n_tiles // tiles_x, tiles_x,
                             width, height, textures, textures_quad_t,
                             camera_pos, light, view, proj, wireframe)


def shade_visibility_fused(
    prep: FusedRasterPrep,
    width: int, height: int,
    # per-vertex attributes (V = 3*T)
    world_nrm: Tensor, v_uv: Tensor, inv_w: Tensor, tri_material: Tensor,
    # material and texture tables
    mat_base_tint: Tensor, mat_uv_scale: Tensor, mat_spec_color: Tensor,
    mat_tex: Tensor, textures: Tensor, tex_size: Tensor,
    textures_quad_t: Tensor,
    camera_pos: Tensor, light: LightParams,
    view: Tensor, proj: Tensor,
    return_depth: bool = False,
    wireframe: bool = False,
):
    """The tiled shade over the fused walk + resolve kernel: the depth and
    slot planes never leave the kernel between the walk and the resolve.
    Every tile is walked to the full width, so the frame equals
    :func:`shade_visibility_tiled` over the walk bit for bit.  Returns
    u8[H, W, 4], or (frame, depth f32[H, W]) with ``return_depth``."""
    tri_row_t = _pack_tri_rows(world_nrm, v_uv, inv_w, tri_material,
                               mat_base_tint, mat_uv_scale, mat_spec_color,
                               mat_tex, tex_size)                     # [28, T]
    tables = _tile_tables(_sub_rows(tri_row_t, prep.sub_raster), prep.ids_w)
    depth_p, slot_p, planes = rr.raster_resolve_tiles(
        prep.counts_walk, prep.tri_pack, tables, prep.tiles_x)
    frame = _shade_tiled_tail(planes, slot_p, depth_p, tri_row_t.shape[0],
                              prep.tiles_y, prep.tiles_x, width, height,
                              textures, textures_quad_t, camera_pos, light,
                              view, proj, wireframe)
    if not return_depth:
        return frame
    depth = untile(depth_p.reshape(-1, TILE_H, TILE_W), prep.tiles_y,
                   prep.tiles_x, height, width)
    return frame, depth
