"""Stage times of the 1080p frame.

Counterpart of the JAX repository's ``scripts/profile_render.py``, on the
port's showcase scene and its camera
(``scene/synthetic.build_showcase_render(0)``; the demo assets that the
JAX script reads are not in the repository), at 1920x1080 with
``bin_capacity=2048``.  Stages, each timed by
:func:`utils.profiling.measure_throughput` (10 queued calls after 2
warm-up, CUDA events on the card):

  bin          - cull, transform, near clip, setup and binning (no raster)
  walk         - the same, then the walk: ``rasterize(backend="walk")``,
                 the port's default visibility
  full_vis     - the same, then the light and heavy full-carry passes:
                 ``rasterize(backend="tile")``
  light        - the light pass alone: the tile raster on the light pass's
                 inputs
  depth        - the depth-only frame, ``make_render_fn(depth_only=True)``
  shade        - the flat gather shade alone on a fixed visibility buffer
  frame_tiled, frame_fused, frame_flat
               - the shaded frame through ``make_render_fn`` in each shade
                 route (``"flat"`` over ``raster_backend="tile"``)

Every stage runs on the eager route (``graphs.eager()``), the frames too:
the times are the eager ops'.

    python3 -m banggameengine_tpu_torch.scripts.profile_render
    python3 -m banggameengine_tpu_torch.scripts.profile_render \\
        --device cpu --small
"""

from __future__ import annotations

import argparse

import torch

from banggameengine_tpu_torch import convert, graphs, math3d
from banggameengine_tpu_torch.render import raster as rz
from banggameengine_tpu_torch.render import raster_tile as rt
from banggameengine_tpu_torch.render.cull import entity_frustum_mask
from banggameengine_tpu_torch.render.pipeline import make_render_fn
from banggameengine_tpu_torch.render.shading import (
    LightParams,
    shade_visibility,
)
from banggameengine_tpu_torch.scene.synthetic import build_showcase_render
from banggameengine_tpu_torch.utils.profiling import measure_throughput

FULL_WH = (1920, 1080)
SMALL_WH = (128, 64)   # the tests' frame: 1 x 2 tiles
BIN_CAPACITY = 2048
REPS = 10
ROUTES = {"tiled": {}, "fused": {"shade_mode": "fused"},
          "flat": {"shade_mode": "flat", "raster_backend": "tile"}}


def showcase(device="cuda", small: bool = False):
    """The showcase on ``device``: (render scene, the frame's arguments
    (world, view, proj, camera position), (width, height))."""
    width, height = SMALL_WH if small else FULL_WH
    sc = build_showcase_render(0)
    rs = convert.render_scene_from_numpy(sc.render, device)
    frame_args = (torch.as_tensor(sc.world, device=device),
                  sc.camera.view_matrix(device),
                  sc.camera.proj_matrix(width / height, device),
                  torch.as_tensor(sc.camera.position, device=device))
    return rs, frame_args, (width, height)


def stages(device="cuda", small: bool = False) -> dict:
    """The stages by name, each as (function, its tensors on ``device``),
    on the showcase at 1920x1080 (``small``: 128x64)."""
    rs, frame_args, (width, height) = showcase(device, small)
    world, view, proj, cam_pos = frame_args

    def front(world_mats):
        vis_ent = entity_frustum_mask(rs.ent_aabb_min, rs.ent_aabb_max,
                                      rs.ent_has_mesh, world_mats, view, proj)
        tri_valid = rs.tri_valid & vis_ent[rs.v_entity[::3].to(torch.int64)]
        _, clip = rz.transform_vertices(rs.v_pos, rs.v_entity, world_mats,
                                        view, proj)
        return clip, tri_valid

    def stage_bin(world_mats):
        return rz._bin_frame(*front(world_mats), width, height, BIN_CAPACITY)

    def stage_raster(backend):
        def run(world_mats):
            vis, _ = rz.rasterize(*front(world_mats), width, height,
                                  bin_capacity=BIN_CAPACITY, backend=backend)
            return vis.depth
        return run

    # a fixed visibility buffer and vertex attributes for the shade alone
    clip, tri_valid = front(world)
    vis, _ = rz.rasterize(clip, tri_valid, width, height,
                          bin_capacity=BIN_CAPACITY, backend="tile",
                          slim=False)
    world_nrm = rz.transform_normals(rs.v_nrm, rs.v_entity,
                                     math3d.normal_matrix(world))
    w = clip[:, 3]
    inv_w = 1.0 / torch.where(w.abs() > 1e-9, w, 1e-9)
    light = LightParams.default(device)

    def stage_shade(tri_id, b1, b2, depth, nrm, iw):
        return shade_visibility(
            tri_id, b1, b2, nrm, rs.v_uv, iw, rs.tri_material,
            rs.mat_base_tint, rs.mat_uv_scale, rs.mat_spec_color, rs.mat_tex,
            rs.textures, rs.tex_size, rs.textures_quad_t, cam_pos, light,
            depth, view, proj)

    out = {
        "bin": (stage_bin, (world,)),
        "walk": (stage_raster("walk"), (world,)),
        "full_vis": (stage_raster("tile"), (world,)),
        "light": (rt.raster_tiles, rz._light_pass(stage_bin(world))),
        "depth": (make_render_fn(rs, width, height, bin_capacity=BIN_CAPACITY,
                                 depth_only=True), frame_args),
        "shade": (stage_shade, (vis.tri_id, vis.b1, vis.b2, vis.depth,
                                world_nrm, inv_w)),
    }
    for route, kw in ROUTES.items():
        out[f"frame_{route}"] = (make_render_fn(
            rs, width, height, bin_capacity=BIN_CAPACITY, **kw), frame_args)
    return {k: (graphs.eager()(fn), args) for k, (fn, args) in out.items()}


def time_stages(runs: dict, device, calls: int = REPS,
                warmup: int = 2) -> dict:
    """Time the stages of :func:`stages` and print one line each (and the
    binning's tile counts); returns ms per call by stage name."""
    device = torch.device(device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    ms = {}
    for stage, (fn, fn_args) in runs.items():
        ms[stage] = measure_throughput(fn, *fn_args, calls=calls,
                                       warmup=warmup) * 1e3
        print(f"{stage:12s} {ms[stage]:8.3f} ms  ({1e3 / ms[stage]:7.1f} /s)"
              f"  ({name})", flush=True)
        if stage == "bin":
            b = fn(*fn_args)
            local = b.local_counts.cpu()
            print(f"{'':12s} tiles={local.numel()} max_locals="
                  f"{int(local.max())} >{rz.LIGHT_CAPACITY} locals: "
                  f"{int((local > rz.LIGHT_CAPACITY).sum())} "
                  f"overflow={int(b.overflow)}", flush=True)
    print(f"depth fps {1e3 / ms['depth']:.1f}   frame fps (tiled) "
          f"{1e3 / ms['frame_tiled']:.1f}")
    return ms


def main(argv=None) -> dict:
    """Build the stages and time them (:func:`time_stages`)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="a 128x64 frame and one timed call (CPU-cheap)")
    args = ap.parse_args(argv)
    runs = stages(args.device, args.small)
    if args.small:
        return time_stages(runs, args.device, calls=1, warmup=1)
    return time_stages(runs, args.device)


if __name__ == "__main__":
    main()
