"""Physics step orchestration: one fixed step of the tick.

Counterpart of ``banggameengine_tpu/physics/step.py``: :func:`scene_census`,
the four routes of :func:`physics_step` and :func:`_finish_step`.  Per
step: the characters (when a slot is in use); gravity; contacts and the
Jacobi solve; semi-implicit Euler integration; the trigger overlap diff.
The routes differ in where the contacts come from:

- ``"dense"`` (the default, ``step.py:492-623``): the all-pairs AABB
  broadphase compacted to neighbor lists, the ``[..., 3]``-minor
  narrowphase manifolds (boxes and solid capsules) and the unified solver
  (:mod:`solver`);
- ``"grid"`` (``step.py:508-523``): the same narrowphase and solver over
  the spatial-hash grid's neighbor lists (:func:`broadphase.
  build_neighbor_lists`), with the layer and dynamic filter per listed
  partner;
- ``"allpairs"``, the JAX package's ``"pallas"`` route (``step.py:277-393``):
  Morton sort, then the all-pairs AABB broadphase (the CUDA kernel on the
  card), the transposed box contacts in sorted space; box-only;
- ``"static"`` (``step.py:394-491``): neighbor lists fixed when the scene
  was built (the flat many-world step, :mod:`parallel.manyworld`), in
  original id order, with the world ``group`` masking the characters'
  obstacles; the transposed contacts take the capsule slots when the
  scene has a solid capsule.  With joints it takes the dense route's
  narrowphase and unified solver over those lists instead.

Joints (:mod:`joints`) run on the dense and static routes; their motors
turn the bodies after gravity and damping, before the contact phase.

The trigger sweep follows the state's trigger plane: bool[T, N] for one
world, per-world blocks bool[W*T, B] for the flat many-world layout.

Characters step by the planar step over static ``char_candidates`` where
given, else by the per-slot step of every slot against every entity.

No step synchronises with the host: every count stays a tensor.
"""

from __future__ import annotations

import dataclasses

import torch

from banggameengine_tpu_torch import math3d
from banggameengine_tpu_torch.ecs.transform import scatter_rows
from banggameengine_tpu_torch.physics import broadphase_kernel as bk
from banggameengine_tpu_torch.physics import character as chr_mod
from banggameengine_tpu_torch.physics import contact_t
from banggameengine_tpu_torch.physics import joints as jt
from banggameengine_tpu_torch.physics import narrowphase as nf
from banggameengine_tpu_torch.physics import shapes as sh_mod
from banggameengine_tpu_torch.physics import solver as sv
from banggameengine_tpu_torch.physics import triggers as tg
from banggameengine_tpu_torch.physics import unified_kernel as uk
from banggameengine_tpu_torch.physics.broadphase import (
    NeighborLists,
    build_neighbor_lists,
    build_neighbor_lists_dense,
)
from banggameengine_tpu_torch.state import (
    BODY_DYNAMIC,
    BODY_KINEMATIC,
    COMP_CHARACTER,
    COMP_COLLIDER,
    FEAT_STRIDE,
    SHAPE_BOX,
    SHAPE_CAPSULE,
    InputFrame,
    StaticScene,
    StepEvents,
    WorldState,
)
from banggameengine_tpu_torch.utils.profiling import span

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
    broadphase: str = "dense",
    grid_cell_size: float = 2.5,
    grid_table_size: int = 4096,
    grid_cell_capacity: int = 8,
    max_neighbors: int = 16,
    trigger_mode: str = "aabb",
    any_char: bool | None = None,
    enable_capsule: bool | None = None,
    any_trig: bool | None = None,
    warm_start: bool = True,
    group: torch.Tensor | None = None,
    static_neighbors: tuple | None = None,
    char_candidates: torch.Tensor | None = None,
    solver_sor: float = 1.0,
    solver_momentum: float = SOLVER_MOMENTUM,
    joints: jt.JointSet | None = None,
    joint_state: jt.JointState | None = None,
    motor_command: torch.Tensor | None = None,
) -> tuple[WorldState, StepEvents]:
    """One fixed physics step, ``(WorldState, InputFrame, StaticScene) ->
    (WorldState, StepEvents)``.

    ``broadphase="dense"`` prunes all pairs by their AABBs to at most
    ``min(max_neighbors, 8)`` partners per body, then runs the narrowphase
    (with the capsule slots when the census finds a solid capsule) and
    :func:`solver.solve_contacts_unified` (on the card, kernel #10:
    :func:`unified_kernel.solve_unified`).

    ``broadphase="grid"`` takes the partners from the spatial hash
    (cells of ``grid_cell_size``, a table of ``grid_table_size`` cells of
    ``grid_cell_capacity`` bodies, at most ``max_neighbors`` partners, not
    clipped to 8), then runs the dense route's narrowphase and solver.

    ``broadphase="allpairs"`` is the JAX package's ``"pallas"`` route: the
    whole contact phase runs in Morton-sorted space, and the all-pairs AABB
    broadphase (:func:`broadphase_kernel.neighbor_lists_aabb`) builds at
    most ``min(max_neighbors, 8)`` partners per body.  Box-only: scenes
    with solid capsules raise ValueError, as in the JAX package.

    ``broadphase="static"`` takes ``static_neighbors=(idx int32[N, K],
    valid bool[N, K])``, partners fixed at build time; ``group`` int32[N]
    confines each character to its own group (world).  The triggers keep
    to their worlds through the state's per-world trigger blocks
    (:func:`_finish_step`).

    Characters step by the planar step over ``char_candidates`` int32[C,
    K] obstacle ids where given, else by the per-slot step over every
    entity.  The InputFrame's fields may be scalars or [C] vectors, one
    entry per character slot.

    The solver warm-starts from the contact cache and refreshes it
    (``warm_start=True``); without it the step solves from zero and keeps
    the old cache.  ``solver_momentum`` is the heavy-ball factor of every
    route, ``solver_sor`` the over-relaxation of the unified solver (the
    dense and grid routes; the transposed solver has none, as in JAX).
    ``trigger_mode`` is ``"aabb"`` (Bullet's ghost pairs) or ``"shape"``
    (exact overlap).  ``any_char``, ``enable_capsule`` and ``any_trig`` are
    the census's; None reads the scene to the host (a step factory does
    that once).

    ``joints`` (:class:`joints.JointSet`) with ``joint_state`` (the
    joints' impulses from the last step) puts the scene's hinges and
    cone-twists into the step: the joints' rows join the unified solve,
    and each body's damping follows gravity.  On the dense route the
    jointed pairs leave the pair mask before the neighbor lists are cut
    to their width; on the static route the contacts are the dense
    route's narrowphase over ``static_neighbors``, which must already
    leave the jointed pairs out (the flat many-world factory's lists do).
    A set with motors (``joints.motored``) needs ``motor_command`` f32[J],
    one command a joint, which drives the hinges' motors
    (:func:`joints.apply_motors`, span ``physics.motors``); a set without
    them takes none (ValueError both ways).  A set with
    ``position_iterations`` holds its anchors together after the
    integration (:func:`joints.project_joints`, span ``physics.joints``).
    The step then returns ``(WorldState, StepEvents, JointState)``.  The
    grid and all-pairs routes given joints raise ValueError.
    """
    if broadphase not in ("dense", "grid", "allpairs", "static"):
        raise ValueError(
            f"unknown broadphase {broadphase!r}: the port's routes are "
            "'dense', 'grid', 'allpairs' (the JAX package's 'pallas' route, "
            "ROADMAP 'Not to port') and 'static'")
    if trigger_mode not in ("aabb", "shape"):
        raise ValueError(f"unknown trigger_mode {trigger_mode!r}")
    if joints is not None:
        if broadphase not in ("dense", "static"):
            raise ValueError(
                f"joints run on broadphase='dense' or 'static' only, not "
                f"{broadphase!r}")
        if joint_state is None:
            raise ValueError("joints need their joint_state")
        if joints.motored != (motor_command is not None):
            raise ValueError(
                "a joint set with motors needs a motor_command, one without "
                "takes none")
    elif motor_command is not None:
        raise ValueError("a motor command needs the joints it drives")
    if any_char is None or enable_capsule is None or any_trig is None:
        census = scene_census(static)
        any_char = census["any_char"] if any_char is None else any_char
        enable_capsule = (census["enable_capsule"] if enable_capsule is None
                          else enable_capsule)
        any_trig = census["any_trig"] if any_trig is None else any_trig
    if enable_capsule and broadphase == "allpairs":
        raise ValueError(
            "broadphase='allpairs' is the box-only stress pipeline; this "
            "scene has solid capsules: use broadphase='dense' or 'grid'")
    if broadphase == "static" and static_neighbors is None:
        raise ValueError(
            "broadphase='static' requires static_neighbors=(idx, valid)")

    # the stages, each a span (utils/profiling.py), one after another:
    # the masks and gravity go to the first, the characters where a slot
    # is in use, else the broadphase
    dev = state.pos.device
    with span("physics.characters" if any_char else "physics.broadphase",
              dev):
        dt = static.fixed_dt
        alive = state.alive
        has_collider = (state.comp_mask
                        & (COMP_COLLIDER | COMP_CHARACTER)) != 0
        is_dynamic = (static.body_type == BODY_DYNAMIC) & alive
        is_kinematic = (static.body_type == BODY_KINEMATIC) & alive
        moving = is_dynamic | is_kinematic

        pos = state.pos
        quat = state.quat

        # 1. characters: kinematic capsules with ghost semantics
        if any_char:
            pos, char_vel_y, char_on_ground = _step_characters(
                state, inp, static, pos, quat, alive & has_collider,
                char_candidates, group)
        else:
            char_vel_y = state.char_vel_y
            char_on_ground = state.char_on_ground

        # 2. rigid bodies: gravity on dynamic bodies (only y changes),
        # then the contact phase
        gdt = static.gravity * dt
        zero = torch.zeros_like(gdt)
        vel = torch.where(is_dynamic[:, None],
                          state.lin_vel + torch.stack([zero, gdt, zero]),
                          state.lin_vel)
        ang = state.ang_vel
        if joints is not None:
            vel, ang = jt.apply_damping(vel, ang, is_dynamic, joints, dt)

        is_char = (state.comp_mask & COMP_CHARACTER) != 0
        # solid = participates in the contact solver (characters are
        # ghosts)
        solid = alive & has_collider & ~is_char
    if joints is not None and joints.motored:
        with span("physics.motors", dev):
            ang = jt.apply_motors(ang, quat, static.inv_inertia_body,
                                  is_dynamic, joints, motor_command, dt)
    solve = dict(iterations=solver_iterations, warm_start=warm_start,
                 momentum=solver_momentum)

    if joints is not None and broadphase == "static":
        nl, pair_ok = _static_lists(static_neighbors, solid, is_dynamic,
                                    pos.device)
        vel, ang, cache, overflow, joint_state = _contacts_dense(
            state, static, pos, quat, vel, ang, solid, is_dynamic, nl,
            pair_ok, enable_capsule, sor=solver_sor, joints=joints,
            joint_state=joint_state, **solve)
    elif broadphase in ("dense", "grid"):
        nl, pair_ok = _neighbor_lists(
            static, pos, quat, solid, is_dynamic, broadphase, max_neighbors,
            grid_cell_size, grid_table_size, grid_cell_capacity, joints)
        vel, ang, cache, overflow, joint_state = _contacts_dense(
            state, static, pos, quat, vel, ang, solid, is_dynamic, nl,
            pair_ok, enable_capsule, sor=solver_sor, joints=joints,
            joint_state=joint_state, **solve)
    elif broadphase == "allpairs":
        vel, ang, cache, overflow = _contacts_allpairs(
            state, static, pos, quat, vel, ang, solid, is_dynamic,
            max_neighbors, **solve)
    else:
        vel, ang, cache, overflow = _contacts_static(
            state, static, pos, quat, vel, ang, solid, is_dynamic,
            static_neighbors, enable_capsule, **solve)
    out = _finish_step(state, static, pos, quat, vel, ang, char_vel_y,
                       char_on_ground, moving, alive, has_collider, dt,
                       any_trig, contact_cache=cache,
                       contact_overflow=overflow, group=group,
                       trigger_mode=trigger_mode, joints=joints,
                       is_dynamic=is_dynamic)
    return out if joints is None else (*out, joint_state)


def _step_characters(state, inp, static, pos, quat, obstacle_base,
                     char_candidates, group):
    """The character step (``step.py:127-239``): the planar step over
    static per-slot candidates where given, else the per-slot step of
    every slot against every entity.  Returns pos with the characters'
    new centres, and the new ``char_vel_y`` and ``char_on_ground``,
    written only for the slots in use (the JAX step also writes an empty
    slot's row 0 back, ROADMAP §3)."""
    c_slots = static.num_char_slots
    char_ent = static.char_entity
    safe_ce = char_ent.clamp_min(0).to(torch.int64)

    def per_vec(v):
        # a scalar input drives every slot; a [C] input one slot each
        return v if v.dim() else v.expand(c_slots)

    inputs = (per_vec(inp.move_forward), per_vec(inp.move_right),
              per_vec(inp.jump), per_vec(inp.sprint), per_vec(inp.cam_yaw))
    slot_params = (static.char_radius, static.char_half_height,
                   static.char_walk_speed, static.char_jump_impulse)
    tail = (static.gravity, static.fixed_dt, static.step_height,
            static.max_slope_cos)
    centres = pos[safe_ce]
    vel_y0 = state.char_vel_y[safe_ce]
    ground0 = state.char_on_ground[safe_ce]
    if char_candidates is None:
        n = pos.shape[0]
        obstacle = (obstacle_base[None, :]
                    & (torch.arange(n, device=pos.device)[None, :]
                       != safe_ce[:, None]))
        if group is not None:
            obstacle = obstacle & (group[None, :] == group[safe_ce][:, None])
        new_c, new_vy, new_ground = chr_mod.step_character(
            centres, vel_y0, ground0, *slot_params, *inputs, pos, quat,
            static.shape_type, static.shape_size, obstacle, *tail)
    else:
        cand = char_candidates.to(torch.int64)           # [C, K]
        ob_c = obstacle_base[cand] & (cand != safe_ce[:, None])
        if group is not None:
            ob_c = ob_c & (group[cand] == group[safe_ce][:, None])
        cand_t = cand.T                                  # [K, C]
        # the candidates' attributes in one channel-major gather: [10, K, C]
        cg = torch.cat([pos.T, quat.T, static.shape_size.T])[:, cand_t]
        ctype = static.shape_type[cand_t]
        ob_t = ob_c.T
        b_is_box = (ctype == SHAPE_BOX) & ob_t
        b_is_cap = (ctype == SHAPE_CAPSULE) & ob_t
        npx, npy, npz, new_vy, new_ground = chr_mod.step_characters_t(
            centres[:, 0], centres[:, 1], centres[:, 2], vel_y0, ground0,
            *slot_params, *inputs,
            cg[0], cg[1], cg[2], cg[3], cg[4], cg[5], cg[6],
            b_is_box, b_is_cap, cg[7], cg[8], cg[9], *tail)
        new_c = torch.stack([npx, npy, npz], dim=1)
    valid = (char_ent >= 0) & state.alive[safe_ce]
    pos = scatter_rows(pos, char_ent,
                       torch.where(valid[:, None], new_c, centres))
    char_vel_y = scatter_rows(state.char_vel_y, char_ent,
                              torch.where(valid, new_vy, vel_y0))
    char_on_ground = scatter_rows(state.char_on_ground, char_ent,
                                  torch.where(valid, new_ground, ground0))
    return pos, char_vel_y, char_on_ground


def _solve(body, cache, pos, quat, vel, ang, contacts, c_feat, dt,
           iterations, warm_start, momentum):
    """The transposed solve of the allpairs and static routes, over their
    rows (sorted or not): ``body`` = the rows' (inv_mass,
    inv_inertia_body, friction, restitution), ``cache`` = their contact
    cache (feature ids [CB, N], impulses [CB, 3, N]).  Returns (vel, ang,
    the refreshed cache (contact_feat [N, C], contact_imp [N, C, 3]) or
    None without ``warm_start``)."""
    inv_m, inertia, fric, rest = body
    args = (vel, ang, pos, quat, inv_m, inertia, *contacts, fric, rest, dt)
    kw = dict(iterations=iterations, ground_friction=GROUND_FRICTION,
              momentum=momentum,
              cache=(c_feat, *cache) if warm_start else None)
    out = contact_t.solve_contacts_t(*args, **kw)
    return out if warm_start else (*out, None)


def _contacts_allpairs(state, static, pos, quat, vel, ang, solid,
                       is_dynamic, max_neighbors, **solve):
    """Broadphase, contacts and solve in Morton-sorted space, each in its
    span."""
    n = state.capacity
    with span("physics.broadphase", pos.device):
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
        dyn_s, layer_s, mask_s = sf[:, 28:31].contiguous().view(
            torch.int32).unbind(1)

        nl = bk.neighbor_lists_aabb(
            sf[:, 0:3], sf[:, 3:6], dyn_s, layer_s, mask_s,
            max_neighbors=min(max_neighbors, 8))
        ground_ok_s = (dyn_s > 0) & static.ground_enabled
        warm_start = solve["warm_start"]
    with span("physics.narrowphase", pos.device):
        out = contact_t.box_contacts_t(
            pos_s, quat_s, half_s, nl.idx, nl.valid, ground_ok_s,
            budget=CONTACT_BUDGET, orig_id=order if warm_start else None)
        contacts, overflow = out[:9], out[9]
        c_feat = out[10] if warm_start else None
    with span("physics.solver", pos.device):
        # the cache lives in ORIGINAL id space (stable across the per-step
        # re-sort): gather to sorted space, match features, gather back
        cache_s = ((state.contact_feat[order].T,               # [CB, N]
                    state.contact_imp[order].permute(1, 2, 0))  # [CB, 3, N]
                   if warm_start else None)
        vel_s, ang_s, cache = _solve(
            (sf[:, 22], sf[:, 23:26], sf[:, 26], sf[:, 27]), cache_s,
            pos_s, quat_s, vel_s, ang_s, contacts, c_feat, static.fixed_dt,
            **solve)
        out = torch.cat([vel_s, ang_s], dim=1)[inv_order]
        if cache is not None:
            cache = (cache[0][inv_order], cache[1][inv_order])
    return out[:, 0:3], out[:, 3:6], cache, overflow


def _contacts_static(state, static, pos, quat, vel, ang, solid, is_dynamic,
                     static_neighbors, enable_capsule, **solve):
    """Contacts and solve over neighbor lists fixed at build time, in
    original id order (no sort: the flat many-world's world blocks are
    contiguous already).  A scene with a solid capsule takes the capsule
    slots of the transposed contacts."""
    n = state.capacity
    with span("physics.broadphase", pos.device):
        nb_idx, nb_valid = static_neighbors
        both = solid & state.alive
        # the partners' validity: the JAX route's select over the shift set
        # reads the same entries as this gather
        nb_ok = nb_valid & both[nb_idx.to(torch.int64)] & both[:, None]
        ground_ok = is_dynamic & solid & static.ground_enabled
        warm_start = solve["warm_start"]
    with span("physics.narrowphase", pos.device):
        out = contact_t.box_contacts_t(
            pos, quat, static.shape_size, nb_idx, nb_ok, ground_ok,
            budget=CONTACT_BUDGET,
            orig_id=(torch.arange(n, dtype=torch.int32, device=pos.device)
                     if warm_start else None),
            shape_type=static.shape_type if enable_capsule else None)
        contacts, overflow = out[:9], out[9]
        c_feat = out[10] if warm_start else None
    with span("physics.solver", pos.device):
        cache = ((state.contact_feat.T, state.contact_imp.permute(1, 2, 0))
                 if warm_start else None)
        vel, ang, cache = _solve(
            (static.inv_mass, static.inv_inertia_body, static.friction,
             static.restitution), cache,
            pos, quat, vel, ang, contacts, c_feat, static.fixed_dt, **solve)
    return vel, ang, cache, overflow


def _static_lists(static_neighbors, solid, is_dynamic, device):
    """The static lists as the dense route's neighbor lists, and the
    validity of each listed pair (both solid, one dynamic)."""
    with span("physics.broadphase", device):
        nb_idx, nb_valid = static_neighbors
        safe_j = nb_idx.to(torch.int64)
        pair_ok = (nb_valid & solid[safe_j] & solid[:, None]
                   & (is_dynamic[safe_j] | is_dynamic[:, None]))
        return NeighborLists(idx=nb_idx, valid=pair_ok, cell_overflow=None,
                             nbr_overflow=None), pair_ok


def _neighbor_lists(static, pos, quat, solid, is_dynamic, broadphase,
                    max_neighbors, cell_size, table_size, cell_capacity,
                    joints=None):
    """The dense or grid route's neighbor lists and the validity of each
    listed pair (solid, layers both ways, at least one dynamic body; on
    the dense route, no joint between them)."""
    with span("physics.broadphase", pos.device):
        if broadphase == "dense":
            layer_ok = (
                ((static.layer[:, None] & static.mask[None, :]) != 0)
                & ((static.layer[None, :] & static.mask[:, None]) != 0))
            any_dyn = is_dynamic[:, None] | is_dynamic[None, :]
            pair_mask = solid[:, None] & solid[None, :] & layer_ok & any_dyn
            if joints is not None:
                pair_mask = pair_mask & ~jt.jointed_pairs(joints,
                                                          pos.shape[0])
            nl = build_neighbor_lists_dense(
                pos, quat, static.shape_type, static.shape_size, pair_mask,
                max_neighbors=min(max_neighbors, 8))
            return nl, nl.valid
        nl = build_neighbor_lists(
            pos, quat, static.shape_type, static.shape_size, active=solid,
            cell_size=cell_size, table_size=table_size,
            cell_capacity=cell_capacity, max_neighbors=max_neighbors)
        safe_j = nl.idx.clamp_min(0).to(torch.int64)
        layer_ok = (((static.layer[:, None] & static.mask[safe_j]) != 0)
                    & ((static.layer[safe_j] & static.mask[:, None]) != 0))
        any_dyn = is_dynamic[:, None] | is_dynamic[safe_j]
        return nl, nl.valid & layer_ok & any_dyn & solid[:, None]


def _contacts_dense(state, static, pos, quat, vel, ang, solid, is_dynamic,
                    nl, pair_ok, enable_capsule, iterations, warm_start,
                    momentum, sor, joints=None, joint_state=None):
    """The dense and grid routes' contacts (``step.py:527-623``):
    narrowphase manifolds of each listed pair that ``pair_ok`` passes and
    of the ground, compaction to the per-body budget, the unified solve
    (with the joints' rows, set up in their own span, where ``joints`` is
    given).  Rows are bodies in id order, ``[N, C]``.  Returns (vel, ang,
    the contact cache, overflow, the new joint state or None)."""
    n = state.capacity
    with span("physics.narrowphase", pos.device):
        safe_j = nl.idx.clamp_min(0).to(torch.int64)

        # the narrowphase on the surviving pairs only
        p_point, p_normal, p_depth, p_gvalid = nf.pair_contacts(
            pos[:, None], quat[:, None],
            static.shape_type[:, None], static.shape_size[:, None],
            pos[safe_j], quat[safe_j],
            static.shape_type[safe_j], static.shape_size[safe_j],
            enable_capsule=enable_capsule)
        p_valid = p_gvalid & (p_depth > 0.0) & pair_ok[..., None]
        g_point, g_normal, g_depth, g_gvalid = nf.ground_contacts(
            pos, quat, static.shape_type, static.shape_size)
        g_valid = (g_gvalid & (g_depth > 0.0) & (is_dynamic & solid)[:, None]
                   & static.ground_enabled)

        # flatten, fold the ground in (partner -1), compact to the budget.
        # Feature ids for the cache: (partner + 1) * FEAT_STRIDE + narrowphase
        # slot k for pair contacts (k names a geometric feature: corner,
        # SAT centre, capsule sample), the bare slot for ground contacts
        k_pair = p_depth.shape[2]
        m_pair = p_depth.shape[1] * k_pair
        partner = nl.idx[:, :, None].expand(p_depth.shape)
        slots = torch.arange(k_pair, dtype=torch.int32, device=pos.device)
        ground_slots = torch.arange(nf.K_GROUND, dtype=torch.int32,
                                    device=pos.device)
        all_b = torch.cat([partner.reshape(n, m_pair),
                           torch.full((n, nf.K_GROUND), -1, dtype=torch.int32,
                                      device=pos.device)], dim=1)
        all_pt = torch.cat([p_point.reshape(n, m_pair, 3), g_point], dim=1)
        all_n = torch.cat([p_normal.reshape(n, m_pair, 3), g_normal], dim=1)
        all_d = torch.cat([p_depth.reshape(n, m_pair), g_depth], dim=1)
        all_v = torch.cat([p_valid.reshape(n, m_pair), g_valid], dim=1)
        all_f = torch.cat([((partner + 1) * FEAT_STRIDE + slots).reshape(
            n, m_pair), ground_slots.expand(n, nf.K_GROUND)], dim=1)
        c_b, c_pt, c_n, c_d, c_valid, overflow, c_f = sv.compact_contacts(
            all_b, all_pt, all_n, all_d, all_v, CONTACT_BUDGET, feat=all_f)
    # the solve opens its own spans (the rows' set-up in physics.joints,
    # the rest in physics.solver) and matches the previous step's impulses
    # by feature id (unique within a row): kernel #10 on the card, its plain
    # twin elsewhere
    unified = (uk.solve_unified if pos.device.type == "cuda"
               else uk.solve_unified_reference)
    jkw = ({} if joints is None else
           dict(joints=joints, joint_state=joint_state, alive=state.alive))
    vel, ang, lams, *rest = unified(
        vel, ang, pos, quat, static.inv_mass, static.inv_inertia_body,
        static.friction, static.restitution, c_b, c_pt, c_n, c_d, c_valid,
        static.fixed_dt, momentum, iterations=iterations, sor=sor,
        ground_friction=GROUND_FRICTION,
        cache=((c_f, state.contact_feat, state.contact_imp)
               if warm_start else None), **jkw)
    cache = None
    if warm_start:
        with span("physics.solver", pos.device):
            cache = (c_f, torch.where(c_valid[..., None],
                                      torch.stack(lams, dim=-1), 0.0))
    return vel, ang, cache, overflow, (rest[0] if rest else None)


def _finish_step(state, static, pos, quat, vel, ang, char_vel_y,
                 char_on_ground, moving, alive, has_collider, dt, any_trig,
                 contact_cache, contact_overflow,
                 group=None,
                 trigger_mode: str = "aabb", joints=None,
                 is_dynamic=None) -> tuple[WorldState, StepEvents]:
    """Shared step tail: integrate, the joints' position pass where the
    set asks for one, triggers, state assembly, each in its span.  The
    contact cache is ``contact_cache`` = (feature ids, impulses), or the
    state's own where it is None (a step without warm start).

    The trigger plane's width picks the sweep: bool[T, N] sweeps every
    trigger against every entity; bool[W*T, B] with B < N (the flat
    many-world layout) sweeps each world's triggers against that world's
    B entities only.  ``group`` with a square plane raises ValueError: a
    many-world state whose plane spans every world would take pairs
    across worlds."""
    if group is not None and state.trigger_overlap.shape[-1] == pos.shape[0]:
        raise ValueError(
            "a world group with a square trigger plane: the flat "
            "many-world layout carries per-world blocks bool[W*T, B], "
            f"not {tuple(state.trigger_overlap.shape)} over "
            f"{pos.shape[0]} entities")
    with span("physics.integrate", pos.device):
        # semi-implicit Euler for dynamic AND kinematic bodies (kinematic
        # velocity is host-driven and persists until changed)
        pos = torch.where(moving[:, None], pos + vel * dt, pos)
        quat = torch.where(moving[:, None],
                           math3d.quat_integrate(quat, ang, dt), quat)
        vel = torch.where(moving[:, None], vel, 0.0)
        ang = torch.where(moving[:, None], ang, 0.0)
        time = state.time + dt
        step_idx = state.step_idx + 1
        overflow = contact_overflow.to(torch.int32)
        if not any_trig:
            # no trigger slot in use: no sweep, and the event diff stays
            # in this span
            enter, stay, exit_, new_overlap, new_active = tg.diff_events(
                state.trigger_overlap,
                torch.zeros_like(state.trigger_overlap),
                static.trig_one_shot, state.trigger_active)

    if joints is not None and joints.position_iterations:
        with span("physics.joints", pos.device):
            pos, quat = jt.project_joints(pos, quat, is_dynamic, alive,
                                          static.inv_mass,
                                          static.inv_inertia_body, joints)

    # triggers: AABB overlap (Bullet's ghost pairs) or exact shape overlap,
    # each trigger against its own world's block of the plane's width
    if any_trig:
        with span("physics.triggers", pos.device):
            overlap_fn = (tg.trigger_aabb_overlaps if trigger_mode == "aabb"
                          else tg.trigger_overlaps)
            overlap = overlap_fn(
                static.trig_entity, static.trig_shape, static.trig_size,
                static.trig_layer, static.trig_mask, state.trigger_active,
                pos, quat, static.shape_type, static.shape_size,
                static.layer, static.mask, alive, has_collider,
                block=state.trigger_overlap.shape[-1],
            )
            enter, stay, exit_, new_overlap, new_active = tg.diff_events(
                state.trigger_overlap, overlap, static.trig_one_shot,
                state.trigger_active)

    new_state = dataclasses.replace(
        state,
        pos=pos,
        quat=quat,
        lin_vel=vel,
        ang_vel=ang,
        char_vel_y=char_vel_y,
        char_on_ground=char_on_ground,
        trigger_overlap=new_overlap,
        trigger_active=new_active,
        time=time,
        step_idx=step_idx,
        contact_feat=(state.contact_feat if contact_cache is None
                      else contact_cache[0]),
        contact_imp=(state.contact_imp if contact_cache is None
                     else contact_cache[1]),
    )
    events = StepEvents(
        trigger_enter=enter, trigger_stay=stay, trigger_exit=exit_,
        contact_overflow=overflow,
    )
    return new_state, events
