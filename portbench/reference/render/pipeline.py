"""Frame pipeline: cull -> transform -> visibility -> deferred shade.

Frozen copy of the port's ``render/pipeline.py`` :func:`render_frame`,
run eagerly over the plain versions of the walk and the resolve (this
copy keeps no kernel); the wireframe frame is left out.
"""

from __future__ import annotations

import torch

from portbench.reference import math3d
from portbench.reference.render import raster as rz
from portbench.reference.render.cull import entity_frustum_mask
from portbench.reference.render.shading import (
    LightParams,
    shade_visibility,
    shade_visibility_fused,
    shade_visibility_tiled,
)

Tensor = torch.Tensor


def render_frame(
    render_scene,          # the render arrays (a RenderScene's fields)
    world_mats: Tensor,    # f32[N,4,4] entity world matrices
    view: Tensor,          # f32[4,4]
    proj: Tensor,          # f32[4,4]
    camera_pos: Tensor,    # f32[3]
    light: LightParams | None = None,
    width: int = 1280,
    height: int = 720,
    bin_capacity: int = 512,
    depth_only: bool = False,
    return_depth: bool = False,
    wireframe: bool = False,
    shade_mode: str = "tiled",
    raster_backend: str = "walk",
):
    """Render one shaded frame u8[H, W, 4], or the NDC depth f32[H, W]
    (``depth_only=True``), or ``(frame, depth)`` (``return_depth=True``).

    ``shade_mode="fused"`` walks inside the fused kernel and ignores
    ``raster_backend``; ``"flat"`` needs ``raster_backend="tile"`` (the
    walk keeps no triangle ids); the depth-only frame takes either
    backend.  ``wireframe=True`` gives the line frame of
    :func:`wireframe_frame` (its depth plane is all 1), and is ignored
    with ``depth_only=True``."""
    rs = render_scene
    if wireframe:
        raise ValueError("the reference draws no wireframe")
    if shade_mode not in ("tiled", "fused", "flat"):
        raise ValueError(f"unknown shade_mode {shade_mode!r}")
    if light is None:
        light = LightParams.default(world_mats.device)

    vis_ent = entity_frustum_mask(rs.ent_aabb_min, rs.ent_aabb_max,
                                  rs.ent_has_mesh, world_mats, view, proj)
    tri_valid = rs.tri_valid & vis_ent[rs.v_entity[::3].to(torch.int64)]
    _, clip = rz.transform_vertices(rs.v_pos, rs.v_entity, world_mats, view,
                                    proj)
    if depth_only:
        vis, _overflow = rz.rasterize(clip, tri_valid, width, height,
                                      bin_capacity=bin_capacity,
                                      backend=raster_backend)
        return vis.depth

    world_nrm = rz.transform_normals(rs.v_nrm, rs.v_entity,
                                     math3d.normal_matrix(world_mats))
    w = clip[:, 3]
    inv_w = 1.0 / torch.where(w.abs() > 1e-9, w, 1e-9)
    shade_args = (world_nrm, rs.v_uv, inv_w, rs.tri_material,
                  rs.mat_base_tint, rs.mat_uv_scale, rs.mat_spec_color,
                  rs.mat_tex, rs.textures, rs.tex_size, rs.textures_quad_t,
                  camera_pos, light)
    if shade_mode == "fused":
        prep = rz.prepare_fused_raster(clip, tri_valid, width, height,
                                       bin_capacity=bin_capacity)
        return shade_visibility_fused(prep, width, height, *shade_args,
                                      view, proj, return_depth=return_depth)
    if shade_mode == "flat":
        vis, _overflow = rz.rasterize(clip, tri_valid, width, height,
                                      bin_capacity=bin_capacity,
                                      backend=raster_backend, slim=False)
        frame = shade_visibility(vis.tri_id, vis.b1, vis.b2, *shade_args,
                                 vis.depth, view, proj)
    else:
        vis, _overflow, tiled = rz.rasterize(
            clip, tri_valid, width, height, bin_capacity=bin_capacity,
            return_tiled=True, backend=raster_backend)
        # the resolve covers the heavy pass's walk width (K_GLOBAL +
        # HEAVY_CAPACITY), which is also the raster's slot ceiling, so the
        # row-gather fallback is statically dead here (JAX pipeline.py:155)
        frame = shade_visibility_tiled(
            tiled, width, height, *shade_args, view, proj,
            shade_slots=rz.K_GLOBAL + rz.LIGHT_CAPACITY,
            heavy_shade_slots=rz.K_GLOBAL + rz.HEAVY_CAPACITY,
            raster_max_slots=rz.K_GLOBAL + rz.HEAVY_CAPACITY)
    if return_depth:
        return frame, vis.depth
    return frame
