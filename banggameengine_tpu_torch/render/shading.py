"""Deferred Blinn-Phong shading of the tiled visibility buffer.

Counterpart of ``banggameengine_tpu/render/shading.py``: the reference's
fragment shader ``fs_basic``

    N = normalize(worldNormal); L = normalize(-lightDir)
    V = normalize(cameraPos - worldPos); H = normalize(L + V)
    rgb = tex.rgb * baseTint.rgb * (ambient + lightColor * max(dot(N, L), 0))
          + specColor * pow(max(dot(N, H), 0), shininess) * specIntensity

with the renderer's global shininess and spec intensity over the
material's, and the 0x88AAFF sky clear.  Each pixel's attributes come from
its tile's table through the resolve (:mod:`resolve`, a CUDA kernel on the
GPU); the barycentrics are recomputed per pixel from the winning
sub-triangle's screen rows, and the world position is unprojected from the
depth plane.  Everything runs on tile-major [tiles, px] planes; only the
final u8 image is untiled.

Ported: the tiled shade over the walk (the JAX package's Pallas resolve
branch) and the channel-major texel-quad sampler.  The JAX package's flat
gather shade, fused raster+resolve shade, XLA one-hot resolve and
row-gather fallback are not (ROADMAP queue 2 #4, #5).
"""

from __future__ import annotations

import dataclasses

import torch

from banggameengine_tpu_torch import math3d
from banggameengine_tpu_torch.render import resolve as rsv
from banggameengine_tpu_torch.render.raster import (
    TILE_W,
    TiledVisibility,
    untile,
)

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
    def default(device: torch.device | str = "cpu") -> "LightParams":
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

    def wrap(i, n):
        return torch.remainder(i.to(torch.int32),
                               n.to(torch.int32).clamp_min(1))

    s = textures.shape[1]
    flat = (tex_id * s + wrap(y0, th)) * s + wrap(x0, tw)
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
                view, proj, textures, textures_quad_t, camera_pos, light):
    """Component-form shading of every pixel.  ``get(c)`` returns the
    pixel's channel ``c`` of the triangle table.  Returns (r, g, b, a)."""
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
    rgb = [torch.where(background, CLEAR_COLOR[i], c)
           for i, c in enumerate(rgb)]
    alpha = torch.where(background, 1.0, alpha)
    return rgb[0], rgb[1], rgb[2], alpha


def _to_u8(x: Tensor) -> Tensor:
    return (x.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


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
) -> Tensor:
    """Tile-major deferred shade -> u8[H, W, 4].

    The resolve covers the full width of ``tiled.ids``, which needs a walk
    that covered every tile to that width (``tiled.full_walk``).  A
    narrower resolve needs the JAX package's row-gather fallback for the
    winners beyond it; that fallback is not ported, so ``full_walk=False``
    raises NotImplementedError.  World positions come from the depth plane
    and shininess from ``light``, so the JAX signature's ``world_pos`` and
    ``mat_spec_params`` are not taken."""
    if not tiled.full_walk:
        raise NotImplementedError(
            "the shade resolves the full walk width only: a partial walk "
            "needs the row-gather fallback, which is not ported (ROADMAP "
            "queue 2 #5)")
    n_tiles, th, tw = tiled.slot.shape
    px_per_tile = th * tw
    tiles_x = -(-width // TILE_W)
    tiles_y = n_tiles // tiles_x

    tri_row_t = _pack_tri_rows(world_nrm, v_uv, inv_w, tri_material,
                               mat_base_tint, mat_uv_scale, mat_spec_color,
                               mat_tex, tex_size)                     # [28, T]
    rb = tri_row_t.shape[0]
    # per-sub-triangle table: each triangle's channels for its two
    # near-clip subs, then the 12 screen-space raster rows
    sub_row_t = torch.cat([torch.repeat_interleave(tri_row_t, 2, dim=1),
                           tiled.sub_raster], dim=0)                  # [40, S]
    ids_w = tiled.ids.clamp_min(0).to(torch.int64)
    tables = sub_row_t.T[ids_w].transpose(1, 2)          # [tiles, 40, KW]
    slot_p = tiled.slot.reshape(n_tiles, px_per_tile)
    planes = rsv.resolve_tiles_wide(slot_p, tables.contiguous())  # [40,t,px]

    def get(c):
        return planes[c]

    # tile-major pixel centres
    tile_ids = torch.arange(n_tiles, device=slot_p.device)
    ox = ((tile_ids % tiles_x) * tw).to(torch.float32)
    oy = ((tile_ids // tiles_x) * th).to(torch.float32)
    p = torch.arange(px_per_tile, device=slot_p.device)
    xi = (p % tw).to(torch.float32)
    yi = (p // tw).to(torch.float32)
    pxc = ox[:, None] + xi[None, :] + 0.5                   # [tiles, px]
    pyc = oy[:, None] + yi[None, :] + 0.5

    # the winning sub-triangle's barycentrics, in the walk's op order, then
    # mapped to the original triangle
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

    rgba = _shade_core(get, b1, b2, pxc, pyc,
                       tiled.depth.reshape(n_tiles, px_per_tile), slot_p < 0,
                       width, height, view, proj, textures, textures_quad_t,
                       camera_pos, light)
    out = torch.stack([_to_u8(c) for c in rgba], dim=-1)    # [tiles, px, 4]
    return untile(out.reshape(n_tiles, th, tw, 4), tiles_y, tiles_x, height,
                  width)
