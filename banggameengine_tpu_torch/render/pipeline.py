"""Frame pipeline: cull -> transform -> visibility -> deferred shade.

Counterpart of ``banggameengine_tpu/render/pipeline.py``: ``render_frame``
(the depth-only frame and three shades), ``make_render_fn``,
``make_interp_render_fn`` (the frame of a world interpolated between two
fixed steps) and ``make_frame_fn`` (the interactive tick: engine steps,
then frame).  Each factory returns captured programs (:mod:`graphs`),
jitted in the JAX package: on the card a call replays CUDA graphs; on the
CPU, or inside :func:`graphs.eager`, it runs eagerly.  Nothing in a frame
synchronises with the host, so the card runs ahead of the caller.

Shades (``shade_mode``): ``"tiled"`` (the default: a raster, then the
per-tile resolve; over the walk, or over ``raster_backend="tile"``, the
light/heavy full-carry raster), ``"fused"`` (the walk and the resolve in
one kernel) and ``"flat"`` (the row-gather shade over the ``"tile"``
raster).  ``wireframe=True`` (the app's F1) draws the scene's
deduplicated mesh edges as true lines over the clear colour
(:mod:`lines`) instead of shading.  Raster backends other than
``"walk"`` and ``"tile"`` raise ValueError naming ROADMAP.
"""

from __future__ import annotations

import functools

import torch

from banggameengine_tpu_torch import graphs, math3d
from banggameengine_tpu_torch.render import raster as rz
from banggameengine_tpu_torch.render.cull import entity_frustum_mask
from banggameengine_tpu_torch.render.lines import draw_lines
from banggameengine_tpu_torch.render.shading import (
    CLEAR_COLOR,
    LightParams,
    shade_visibility,
    shade_visibility_fused,
    shade_visibility_tiled,
)
from banggameengine_tpu_torch.scene.build import BuiltScene, RenderScene
from banggameengine_tpu_torch.utils.profiling import span

Tensor = torch.Tensor


def render_frame(
    render_scene: RenderScene,
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
    if wireframe and not depth_only:
        frame = wireframe_frame(rs, world_mats, view, proj, width, height)
        if return_depth:
            return frame, torch.ones((height, width), device=frame.device)
        return frame
    if shade_mode not in ("tiled", "fused", "flat"):
        raise ValueError(f"unknown shade_mode {shade_mode!r}")
    device = world_mats.device
    with span("render.raster", device):
        vis_ent = entity_frustum_mask(rs.ent_aabb_min, rs.ent_aabb_max,
                                      rs.ent_has_mesh, world_mats, view,
                                      proj)
        tri_valid = rs.tri_valid & vis_ent[rs.v_entity[::3].to(torch.int64)]
        _, clip = rz.transform_vertices(rs.v_pos, rs.v_entity, world_mats,
                                        view, proj)
        if depth_only:
            vis, _overflow = rz.rasterize(clip, tri_valid, width, height,
                                          bin_capacity=bin_capacity,
                                          backend=raster_backend)
            return vis.depth
        if shade_mode == "fused":
            prep = rz.prepare_fused_raster(clip, tri_valid, width, height,
                                           bin_capacity=bin_capacity)
        elif shade_mode == "flat":
            vis, _overflow = rz.rasterize(clip, tri_valid, width, height,
                                          bin_capacity=bin_capacity,
                                          backend=raster_backend, slim=False)
        else:
            vis, _overflow, tiled = rz.rasterize(
                clip, tri_valid, width, height, bin_capacity=bin_capacity,
                return_tiled=True, backend=raster_backend)

    with span("render.shade", device):
        if light is None:
            light = LightParams.default(device)
        world_nrm = rz.transform_normals(rs.v_nrm, rs.v_entity,
                                         math3d.normal_matrix(world_mats))
        w = clip[:, 3]
        inv_w = 1.0 / torch.where(w.abs() > 1e-9, w, 1e-9)
        shade_args = (world_nrm, rs.v_uv, inv_w, rs.tri_material,
                      rs.mat_base_tint, rs.mat_uv_scale, rs.mat_spec_color,
                      rs.mat_tex, rs.textures, rs.tex_size,
                      rs.textures_quad_t, camera_pos, light)
        if shade_mode == "fused":
            return shade_visibility_fused(prep, width, height, *shade_args,
                                          view, proj,
                                          return_depth=return_depth)
        if shade_mode == "flat":
            frame = shade_visibility(vis.tri_id, vis.b1, vis.b2,
                                     *shade_args, vis.depth, view, proj)
        else:
            # the resolve covers the heavy pass's walk width (K_GLOBAL +
            # HEAVY_CAPACITY), which is also the raster's slot ceiling, so
            # the row-gather fallback is statically dead here (JAX
            # pipeline.py:155)
            frame = shade_visibility_tiled(
                tiled, width, height, *shade_args, view, proj,
                shade_slots=rz.K_GLOBAL + rz.LIGHT_CAPACITY,
                heavy_shade_slots=rz.K_GLOBAL + rz.HEAVY_CAPACITY,
                raster_max_slots=rz.K_GLOBAL + rz.HEAVY_CAPACITY)
    if return_depth:
        return frame, vis.depth
    return frame


def wireframe_frame(render_scene: RenderScene, world_mats: Tensor,
                    view: Tensor, proj: Tensor, width: int,
                    height: int) -> Tensor:
    """The F1 wireframe u8[H, W, 4]: every deduplicated mesh edge as a
    white true line over the clear colour, depth-tested against nothing
    (the reference's ``BGFX_DEBUG_WIREFRAME`` replaces fill with line
    raster and, like bgfx's debug mode, removes no hidden lines)."""
    rs = render_scene
    device = world_mats.device
    clear = [int(c * 255) for c in CLEAR_COLOR] + [255]
    frame = torch.stack([torch.full((height, width), c, dtype=torch.uint8,
                                    device=device) for c in clear], dim=-1)
    wm = world_mats[rs.edge_entity.to(torch.int64)]            # [E, 4, 4]
    pts = (torch.einsum("eij,ekj->eki", wm[:, :3, :3], rs.edge_pos)
           + wm[:, None, :3, 3])
    colors = torch.ones((rs.edge_pos.shape[0], 4), device=device)
    return draw_lines(frame, torch.ones((height, width), device=device), pts,
                      colors, rs.edge_valid, view, proj)


def make_render_fn(render_scene: RenderScene, width: int, height: int,
                   bin_capacity: int = 512, depth_only: bool = False,
                   return_depth: bool = False, wireframe: bool = False,
                   raster_backend: str = "walk", shade_mode: str = "tiled"):
    """A frame renderer bound to the render scene:
    ``call(world_mats, view, proj, camera_pos, light=None)``.
    ``shade_mode`` is the port's addition to the JAX signature.

    On the card a call replays the frame's graph: the world, the camera
    and the light are copied into its buffers, the scene is captured by
    reference, and the frame returned is a clone."""
    fn = functools.partial(
        render_frame, width=width, height=height,
        bin_capacity=bin_capacity, depth_only=depth_only,
        return_depth=return_depth, wireframe=wireframe,
        raster_backend=raster_backend, shade_mode=shade_mode)
    program = graphs.Program(fn, by_ref=(0,), name="render")

    def call(world_mats, view, proj, camera_pos, light=None):
        return program(render_scene, world_mats, view, proj, camera_pos,
                       light)

    call.program = program
    return call


def make_interp_render_fn(render_scene: RenderScene, width: int, height: int,
                          bin_capacity: int = 512,
                          return_depth: bool = False,
                          wireframe: bool = False,
                          raster_backend: str = "walk"):
    """A renderer of interpolated motion states:
    ``call(prev_state, state, alpha, static, view, proj, cam_pos,
    light=None)`` blends the two fixed-step states by ``alpha``
    (:func:`~banggameengine_tpu_torch.engine.interpolated_world`), then
    renders the blended world, in one call, through the tiled shade over
    ``raster_backend``.  On the card that call is one graph; ``alpha``
    (a float or a 0-d tensor) enters it as an f32 0-d tensor on the
    states' device, like the states, the scene and the camera, so no
    value of one call is frozen into the next."""
    from banggameengine_tpu_torch.engine import interpolated_world

    def frame(rs, prev_state, state, alpha, static, view, proj, cam_pos,
              light):
        world = interpolated_world(prev_state, state, alpha, static)
        return render_frame(rs, world, view, proj, cam_pos, light,
                            width=width, height=height,
                            bin_capacity=bin_capacity,
                            return_depth=return_depth, wireframe=wireframe,
                            raster_backend=raster_backend)

    program = graphs.Program(frame, by_ref=(0,), name="interp_render")

    def call(prev_state, state, alpha, static, view, proj, cam_pos,
             light=None):
        alpha = torch.as_tensor(alpha, dtype=torch.float32,
                                device=state.pos.device)
        return program(render_scene, prev_state, state, alpha, static,
                       view, proj, cam_pos, light)

    call.program = program
    return call


def make_frame_fn(built: BuiltScene, width: int, height: int,
                  solver_iterations: int = 10, bin_capacity: int = 2048,
                  pipelined: bool = False, substeps: int = 1,
                  merged: bool = False, merged_barrier: bool = False,
                  donate: bool = True, raster_backend: str = "walk",
                  **physics_kwargs):
    """The interactive tick: ``substeps`` engine steps, then the shaded
    frame of the new world (the tiled shade over ``raster_backend``), with
    no host synchronisation in between.

    Returns ``call(state, inp, view, proj, cam_pos, light=None)
    -> (new_state, u8[H, W, 4], StepEvents)``; with ``substeps > 1`` the
    events gain a leading [substeps] axis.  ``call.update_static(static)``
    rebinds the static scene, as in JAX.  The graphs capture the scene by
    reference (in-place writes to it, ``ecs.lifecycle``'s, reach them):
    the next call copies a rebound scene of the same shapes into the
    tensors they captured, and one of other shapes is captured anew.

    On the card, as in JAX: by default two graphs, the step (its
    ``substeps`` steps unrolled in one capture) and then the frame;
    ``merged=True`` or ``merged_barrier=True`` one graph of both (its
    order is step then frame, so the barrier adds nothing).
    ``pipelined=True`` renders the world of the state passed in (one tick
    of visual latency) and then steps (not with ``merged``, as in JAX).
    ``donate=True`` consumes the state passed in: the returned state and
    events are the graph's buffers, valid until the next call; the frame
    is a clone.  ``donate=False`` returns clones of all three."""
    from banggameengine_tpu_torch.engine import engine_step, stack_events
    from banggameengine_tpu_torch.physics.step import scene_census

    kwargs = {**scene_census(built.static), **physics_kwargs}
    bound = {"st": built.static}
    rs = built.render

    def step(state, inp, st):
        events = []
        for _ in range(substeps):
            state, ev = engine_step(state, inp, st, solver_iterations,
                                    **kwargs)
            events.append(ev)
        if substeps == 1:
            return state, events[0]
        return state, stack_events(events)

    def render(rs_, world, view, proj, cam_pos, light):
        return render_frame(rs_, world, view, proj, cam_pos, light,
                            width=width, height=height,
                            bin_capacity=bin_capacity,
                            raster_backend=raster_backend)

    def tick(state, inp, st, rs_, view, proj, cam_pos, light):
        s2, ev = step(state, inp, st)
        return s2, render(rs_, s2.world, view, proj, cam_pos, light), ev

    merged = merged or merged_barrier
    tick_program = graphs.Program(tick, donate=donate, by_ref=(2, 3),
                                  name="tick")
    step_program = graphs.Program(step, donate=donate, by_ref=(2,),
                                  name="tick_step")
    render_program = graphs.Program(render, by_ref=(0,), name="tick_render")

    def call(state, inp, view, proj, cam_pos, light=None):
        st = bound["st"]
        if merged:
            s2, img, ev = tick_program(state, inp, st, rs, view, proj,
                                       cam_pos, light)
            return s2, graphs.clone_tree(img) if donate else img, ev
        if pipelined:
            img = render_program(rs, state.world, view, proj, cam_pos,
                                 light)
            s2, ev = step_program(state, inp, st)
            return s2, img, ev
        s2, ev = step_program(state, inp, st)
        return s2, render_program(rs, s2.world, view, proj, cam_pos,
                                  light), ev

    def update_static(new_static):
        bound["st"] = new_static

    call.update_static = update_static
    call.programs = (step_program, render_program, tick_program)
    return call
