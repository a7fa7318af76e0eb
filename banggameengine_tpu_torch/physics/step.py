"""Physics step orchestration: one fixed step of the stress route.

Counterpart of ``banggameengine_tpu/physics/step.py``: :func:`scene_census`,
the all-pairs route of :func:`physics_step` (the JAX package's
``broadphase="pallas"``, ``step.py:277-393``) and :func:`_finish_step`.
Per step: gravity; Morton sort; all-pairs AABB broadphase (the CUDA kernel
on the card); box contacts and the warm-started Jacobi solve in sorted
space; semi-implicit Euler integration; trigger overlap diff.

Not ported yet, and refused with NotImplementedError: the other broadphase
routes (``dense``, ``grid``, the flat many-world ``static``) and scenes with
a character in use.  Left out, since no caller sets them: the JAX step's
``warm_start=False``, ``trigger_mode="shape"`` and ``solver_momentum``
options (the port runs their defaults).

No step synchronises with the host: every count stays a tensor.
"""

from __future__ import annotations

import dataclasses

import torch

from banggameengine_tpu_torch import math3d
from banggameengine_tpu_torch.physics import broadphase_kernel as bk
from banggameengine_tpu_torch.physics import contact_t
from banggameengine_tpu_torch.physics import shapes as sh_mod
from banggameengine_tpu_torch.physics import triggers as tg
from banggameengine_tpu_torch.state import (
    BODY_DYNAMIC,
    BODY_KINEMATIC,
    COMP_CHARACTER,
    COMP_COLLIDER,
    SHAPE_CAPSULE,
    InputFrame,
    StaticScene,
    StepEvents,
    WorldState,
)

GROUND_FRICTION = 0.5  # implicit plane uses Bullet's default friction
SOLVER_ITERATIONS = 10
SOLVER_MOMENTUM = 0.5  # heavy-ball factor (the JAX step's default)
CONTACT_BUDGET = 12    # max solved contacts per body after compaction


def scene_census(static: StaticScene) -> dict:
    """Host-side census of a static scene: the booleans that let
    :func:`physics_step` skip dead stages (character sweep, capsule
    narrowphase, trigger overlap).  Reads the scene to the host once; step
    factories call it, and steps receive the result as arguments."""
    st_np = static.shape_type.cpu().numpy()
    bt_np = static.body_type.cpu().numpy()
    caps = (st_np == SHAPE_CAPSULE) & (bt_np > 0)
    ce_np = static.char_entity.cpu().numpy()
    caps[ce_np[ce_np >= 0]] = False  # character ghosts never solve
    return dict(
        any_char=bool((ce_np >= 0).any()),
        enable_capsule=bool(caps.any()),
        any_trig=bool((static.trig_entity.cpu().numpy() >= 0).any()),
    )


def _bits(a: torch.Tensor) -> torch.Tensor:
    """int32 tensor -> f32 tensor with the same bits (to ride an f32 pack)."""
    return a.to(torch.int32).view(torch.float32)


def physics_step(
    state: WorldState,
    inp: InputFrame,
    static: StaticScene,
    solver_iterations: int = SOLVER_ITERATIONS,
    broadphase: str = "allpairs",
    max_neighbors: int = 16,
    any_char: bool | None = None,
    enable_capsule: bool | None = None,
    any_trig: bool | None = None,
) -> tuple[WorldState, StepEvents]:
    """One fixed physics step, ``(WorldState, InputFrame, StaticScene) ->
    (WorldState, StepEvents)``.

    ``broadphase="allpairs"`` is the JAX package's ``"pallas"`` route: the
    whole contact phase runs in Morton-sorted space, and the all-pairs AABB
    broadphase (:func:`broadphase_kernel.neighbor_lists_aabb`) builds at
    most ``min(max_neighbors, 8)`` partners per body.  The contact cache
    warm-starts the solver, and triggers use AABB overlap, as the JAX
    step's defaults do.  Box-only: scenes with solid capsules raise
    ValueError, as in the JAX package.
    """
    del inp  # read only by the character step, which is not ported yet
    if broadphase != "allpairs":
        raise NotImplementedError(
            f"broadphase={broadphase!r} is not ported; only 'allpairs' (the "
            "JAX package's 'pallas' route) is. See ROADMAP queue 1, item 8 "
            "('static') and item 16 ('dense', 'grid')")
    if any_char is None or enable_capsule is None or any_trig is None:
        census = scene_census(static)
        any_char = census["any_char"] if any_char is None else any_char
        enable_capsule = (census["enable_capsule"] if enable_capsule is None
                          else enable_capsule)
        any_trig = census["any_trig"] if any_trig is None else any_trig
    if any_char:
        raise NotImplementedError(
            "scenes with a character in use are not ported yet: the "
            "character step waits for ROADMAP queue 1, item 6")
    if enable_capsule:
        raise ValueError(
            "broadphase='allpairs' is the box-only stress pipeline; this "
            "scene has solid capsules")

    dt = static.fixed_dt
    n = state.capacity
    alive = state.alive
    has_collider = (state.comp_mask & (COMP_COLLIDER | COMP_CHARACTER)) != 0
    is_dynamic = (static.body_type == BODY_DYNAMIC) & alive
    is_kinematic = (static.body_type == BODY_KINEMATIC) & alive
    moving = is_dynamic | is_kinematic

    pos = state.pos
    quat = state.quat

    # gravity on dynamic bodies: only the y component changes
    gdt = static.gravity * dt
    zero = torch.zeros_like(gdt)
    vel = torch.where(is_dynamic[:, None],
                      state.lin_vel + torch.stack([zero, gdt, zero]),
                      state.lin_vel)
    ang = state.ang_vel

    is_char = (state.comp_mask & COMP_CHARACTER) != 0
    # solid = participates in the contact solver (characters are ghosts)
    solid = alive & has_collider & ~is_char

    # The whole contact phase runs in Morton-sorted space.  The sort must
    # be stable: tied keys are common (57 of 10,000 at step 0 of the stress
    # scene), and the tie order fixes the neighbor lists.
    order = torch.argsort(bk.morton_key_xz(pos), stable=True)
    inv_order = torch.empty_like(order)
    inv_order[order] = torch.arange(n, device=order.device)
    mn, mx = sh_mod.shape_aabb(pos, quat, static.shape_type,
                               static.shape_size)
    dyn_flag = torch.where(solid, is_dynamic.to(torch.int32), -1)

    # one packed gather carries every per-body attribute into sorted order;
    # int fields ride as their f32 bit patterns
    feat = torch.cat(
        [mn, mx, pos, quat, vel, ang, static.shape_size,
         static.inv_mass[:, None], static.inv_inertia_body,
         static.friction[:, None], static.restitution[:, None],
         _bits(dyn_flag)[:, None], _bits(static.layer)[:, None],
         _bits(static.mask)[:, None]], dim=1)             # [N, 31]
    sf = feat[order]

    pos_s, quat_s = sf[:, 6:9], sf[:, 9:13]
    vel_s, ang_s = sf[:, 13:16], sf[:, 16:19]
    half_s = sf[:, 19:22]
    inv_m_s, inertia_s = sf[:, 22], sf[:, 23:26]
    fric_s, rest_s = sf[:, 26], sf[:, 27]
    dyn_s, layer_s, mask_s = sf[:, 28:31].contiguous().view(
        torch.int32).unbind(1)

    nl = bk.neighbor_lists_aabb(
        sf[:, 0:3], sf[:, 3:6], dyn_s, layer_s, mask_s,
        max_neighbors=min(max_neighbors, 8))
    ground_ok_s = (dyn_s > 0) & static.ground_enabled
    (c_prt, c_ptx, c_pty, c_ptz, c_nx, c_ny, c_nz, c_dep, c_valid,
     contact_overflow, c_feat) = contact_t.box_contacts_t(
        pos_s, quat_s, half_s, nl.idx, nl.valid, ground_ok_s,
        budget=CONTACT_BUDGET, orig_id=order)
    # the cache lives in ORIGINAL id space (stable across the per-step
    # re-sort): gather to sorted space, match features, gather back.  The
    # match is a one-hot select (feature ids are unique per row), so
    # summing its products moves each cached impulse exactly.
    cache_feat_s = state.contact_feat[order].T                  # [CB, N]
    cache_imp_s = state.contact_imp[order].permute(1, 2, 0)     # [CB, 3, N]
    eq = ((c_feat[:, None, :] == cache_feat_s[None, :, :])
          & (c_feat >= 0)[:, None, :]).to(torch.float32)       # [C, CB, N]
    warm = (eq[:, :, None, :] * cache_imp_s[None]).sum(dim=1)   # [C, 3, N]
    vel_s, ang_s, (ln, lt1, lt2) = contact_t.solve_contacts_t(
        vel_s, ang_s, pos_s, quat_s, inv_m_s, inertia_s,
        c_prt, c_ptx, c_pty, c_ptz, c_nx, c_ny, c_nz, c_dep,
        c_valid, fric_s, rest_s, dt, iterations=solver_iterations,
        ground_friction=GROUND_FRICTION, warm=warm.unbind(1),
        return_lambdas=True, momentum=SOLVER_MOMENTUM)
    imp_s = torch.where(c_valid.T[..., None],
                        torch.stack([ln.T, lt1.T, lt2.T], dim=-1), 0.0)
    feat_s = torch.where(c_valid, c_feat, -1).T                  # [N, C]
    out = torch.cat([vel_s, ang_s], dim=1)[inv_order]
    return _finish_step(state, static, pos, quat, out[:, 0:3], out[:, 3:6],
                        moving, alive, has_collider, dt, any_trig,
                        contact_feat=feat_s[inv_order],
                        contact_imp=imp_s[inv_order],
                        contact_overflow=contact_overflow)


def _finish_step(state, static, pos, quat, vel, ang, moving, alive,
                 has_collider, dt, any_trig, contact_feat, contact_imp,
                 contact_overflow) -> tuple[WorldState, StepEvents]:
    """Shared step tail: integrate, triggers, state assembly."""
    # semi-implicit Euler for dynamic AND kinematic bodies (kinematic
    # velocity is host-driven and persists until changed)
    pos = torch.where(moving[:, None], pos + vel * dt, pos)
    quat = torch.where(moving[:, None], math3d.quat_integrate(quat, ang, dt),
                       quat)
    vel = torch.where(moving[:, None], vel, 0.0)
    ang = torch.where(moving[:, None], ang, 0.0)

    # triggers: AABB overlap (Bullet's ghost pairs); scenes with no trigger
    # slot in use skip the sweep
    if any_trig:
        overlap = tg.trigger_aabb_overlaps(
            static.trig_entity, static.trig_shape, static.trig_size,
            static.trig_layer, static.trig_mask, state.trigger_active,
            pos, quat, static.shape_type, static.shape_size,
            static.layer, static.mask, alive, has_collider,
        )
    else:
        overlap = torch.zeros_like(state.trigger_overlap)
    enter, stay, exit_, new_overlap, new_active = tg.diff_events(
        state.trigger_overlap, overlap, static.trig_one_shot,
        state.trigger_active)

    new_state = dataclasses.replace(
        state,
        pos=pos,
        quat=quat,
        lin_vel=vel,
        ang_vel=ang,
        trigger_overlap=new_overlap,
        trigger_active=new_active,
        time=state.time + dt,
        step_idx=state.step_idx + 1,
        contact_feat=contact_feat,
        contact_imp=contact_imp,
    )
    events = StepEvents(
        trigger_enter=enter, trigger_stay=stay, trigger_exit=exit_,
        contact_overflow=contact_overflow.to(torch.int32),
    )
    return new_state, events
