"""Fully sharded single world: state and compute split over the ranks.

Counterpart of ``banggameengine_tpu/parallel/sharded_world.py``.  The
``WorldState`` and ``StaticScene`` body arrays live sharded over an
``("entity",)`` mesh: each rank holds N / D rows of every ``[N, ...]``
array (a ``Shard(0)`` DTensor), the ``[T, N]`` trigger planes their
columns (``Shard(1)``), and the slot tables and scalars are replicated.
Per step each rank:

1. steps every character slot against transient gathered full views and
   writes the slots it owns;
2. applies gravity to its local dynamic rows;
3. gathers the pose, velocity and static columns it needs to see
   potential partners (transient [N, ...] views; the persistent state
   stays sharded);
4. runs the shared local-rows contact pipeline
   (:func:`spatial.local_rows_contact_solve`: dense AABB broadphase of its
   rows against the gathered world, local narrowphase, mirrored-row
   Jacobi solve with one velocity all-gather per iteration);
5. integrates its rows (dynamic and kinematic) and refreshes their world
   matrices: locally for a flat hierarchy, over gathered full views when
   the scene has parents (the level-ordered propagation is then repeated
   on every rank);
6. evaluates its columns of the trigger overlap and diffs the events; a
   oneShot trigger deactivates on an Enter summed over the ranks.

The step makes no warm start (the contact cache is carried unchanged), as
in the JAX module.
"""

from __future__ import annotations

import torch

from banggameengine_tpu_torch import math3d
from banggameengine_tpu_torch.ecs.transform import update_world_matrices
from banggameengine_tpu_torch.parallel import ranks
from banggameengine_tpu_torch.parallel.spatial import (
    local_rows_contact_solve,
)
from banggameengine_tpu_torch.physics import character as chr_mod
from banggameengine_tpu_torch.physics import shapes as sh
from banggameengine_tpu_torch.state import (
    BODY_DYNAMIC,
    BODY_KINEMATIC,
    COMP_CHARACTER,
    COMP_COLLIDER,
    InputFrame,
    StaticScene,
    StepEvents,
    WorldState,
    tree_replace,
)

AXIS = "entity"

# the per-body columns one packed gather carries (f32, the int columns as
# their bit patterns): pose and velocity, then the static columns
_POSE = (("pos", 3), ("quat", 4), ("vel", 3), ("ang", 3))
_COLUMNS = (("size", 3), ("friction", 1), ("restitution", 1),
            ("inv_mass", 1), ("inv_inertia", 3), ("shape_type", 1),
            ("layer", 1), ("mask", 1), ("dyn", 1), ("solid", 1))
_INT_COLUMNS = ("shape_type", "layer", "mask", "dyn", "solid")


def make_entity_axis_mesh(n_devices: int | None = None,
                          device_type: str = "cuda"):
    """1-D mesh over the ranks of the initialised process group, its dim
    named ``"entity"``; ``n_devices``, where given, must be the group's
    size."""
    return ranks.make_mesh(
        AXIS, device_type,
        None if n_devices is None else range(n_devices))


def _placement(a: torch.Tensor, n: int):
    """Rows with a leading body axis shard; [T, N] trigger planes shard
    their column axis; everything else replicates."""
    from torch.distributed.tensor import Replicate, Shard

    if a.dim() >= 1 and a.shape[0] == n:
        return Shard(0)
    if a.dim() >= 2 and a.shape[1] == n:
        return Shard(1)
    return Replicate()


def shard_world(state: WorldState, static: StaticScene, mesh):
    """Place a world (whole on every rank) onto the mesh, row-sharded:
    every ``[N, ...]`` array split over the ranks, the ``[T, N]`` trigger
    planes by columns, scalars and slot tables replicated.  Returns
    ``(state, static)`` as DTensors.  No collective."""
    n = state.capacity
    n_dev = mesh.size()
    if n % n_dev:
        raise ValueError(f"capacity {n} not divisible by {n_dev} ranks")

    def place(a):
        return ranks.distribute(a.contiguous(), mesh, _placement(a, n))

    return ranks.map_fields(place, state), ranks.map_fields(place, static)


def _pack(cols: dict, names) -> torch.Tensor:
    parts = []
    for name, width in names:
        a = cols[name]
        if name in _INT_COLUMNS:
            a = a.to(torch.int32).view(torch.float32)
        parts.append(a.reshape(a.shape[0], width))
    return torch.cat(parts, dim=1)


def _unpack(packed: torch.Tensor, names, like: dict) -> dict:
    out, c = {}, 0
    for name, width in names:
        a = packed[:, c:c + width]
        if name in _INT_COLUMNS:
            a = a.contiguous().view(torch.int32).to(like[name].dtype)
        out[name] = a[:, 0] if like[name].dim() == 1 else a
        c += width
    return out


def make_fully_sharded_step(static: StaticScene, mesh,
                            solver_iterations: int = 10,
                            max_neighbors: int = 8,
                            aabb_margin: float = 0.04):
    """``step(state, inp, static) -> (state, StepEvents)`` over the
    row-sharded world of :func:`shard_world`.

    ``static`` here is the whole scene (the census that prunes dead
    stages is read from it on the host, once); the call takes the sharded
    static.  The input is replicated (the same on every rank).  The
    events' ``[T, N]`` planes are sharded by columns as the trigger
    overlap is; ``contact_overflow`` is 0, as in the JAX module.
    """
    n_dev = mesh.size()
    rank = mesh.get_local_rank()
    group = mesh.get_group()
    ce_np = static.char_entity.cpu().numpy()
    any_char = bool((ce_np >= 0).any())
    any_trig = bool((static.trig_entity.cpu().numpy() >= 0).any())
    flat_hierarchy = not bool((static.parent.cpu().numpy() >= 0).any())
    c_slots = int(ce_np.shape[0])

    def gather(a):
        return ranks.gather_rows(a, group)

    def step(state: WorldState, inp: InputFrame, st: StaticScene):
        n = state.capacity
        rows = n // n_dev
        r0 = rank * rows
        dev = ranks.local(state.pos).device
        loc, rep = ranks.local, ranks.replicated
        dt = rep(st.fixed_dt)
        gravity = rep(st.gravity)
        pos_l, quat_l = loc(state.pos), loc(state.quat)
        vel_l, ang_l = loc(state.lin_vel), loc(state.ang_vel)
        alive_l, comp_l = loc(state.alive), loc(state.comp_mask)
        cvy_l, cog_l = loc(state.char_vel_y), loc(state.char_on_ground)
        scale_l = loc(state.scale)
        trig_ov_l = loc(state.trigger_overlap)
        trig_active = rep(state.trigger_active)
        stc = dict(shape_type=loc(st.shape_type), size=loc(st.shape_size),
                   layer=loc(st.layer), mask=loc(st.mask),
                   friction=loc(st.friction),
                   restitution=loc(st.restitution),
                   inv_mass=loc(st.inv_mass),
                   inv_inertia=loc(st.inv_inertia_body))
        inp_ = ranks.map_fields(rep, inp)
        local_ids = r0 + torch.arange(rows, device=dev)
        body_type = loc(st.body_type)

        has_col_l = (comp_l & (COMP_COLLIDER | COMP_CHARACTER)) != 0
        is_char_l = (comp_l & COMP_CHARACTER) != 0
        dyn_l = (body_type == BODY_DYNAMIC) & alive_l
        kin_l = (body_type == BODY_KINEMATIC) & alive_l
        solid_l = alive_l & has_col_l & ~is_char_l

        # ---- 1. characters (against transient full views) -------------
        if any_char:
            char_entity = rep(st.char_entity)
            pos_f0, quat_f0 = gather(pos_l), gather(quat_l)
            alive_f = gather(alive_l)
            comp_f = gather(comp_l)
            type_f, size_f = gather(stc["shape_type"]), gather(stc["size"])
            cvy_f, cog_f = gather(cvy_l), gather(cog_l)
            has_col_f = (comp_f & (COMP_COLLIDER | COMP_CHARACTER)) != 0
            safe = char_entity.clamp_min(0).to(torch.int64)
            obstacle = ((alive_f & has_col_f)[None, :]
                        & (torch.arange(n, device=dev)[None, :]
                           != safe[:, None]))

            def per_slot(v):
                # a scalar input drives every slot
                return v if v.dim() else v.expand(c_slots)

            new_c, new_vy, new_g = chr_mod.step_character(
                pos_f0[safe], cvy_f[safe], cog_f[safe],
                rep(st.char_radius), rep(st.char_half_height),
                rep(st.char_walk_speed), rep(st.char_jump_impulse),
                per_slot(inp_.move_forward), per_slot(inp_.move_right),
                per_slot(inp_.jump), per_slot(inp_.sprint),
                per_slot(inp_.cam_yaw),
                pos_f0, quat_f0, type_f, size_f, obstacle, gravity, dt,
                rep(st.step_height), rep(st.max_slope_cos))
            ok = (char_entity >= 0) & alive_f[safe]
            owned = ok & (safe >= r0) & (safe < r0 + rows)
            rel = (safe - r0).clamp(0, rows - 1)
            rows_ar = torch.arange(rows, device=dev)
            for s in range(c_slots):
                hit = owned[s] & (rows_ar == rel[s])
                pos_l = torch.where(hit[:, None], new_c[s], pos_l)
                cvy_l = torch.where(hit, new_vy[s], cvy_l)
                cog_l = torch.where(hit, new_g[s], cog_l)

        # ---- 2. gravity on local dynamic rows ---------------------------
        gdt = gravity * dt
        zero = torch.zeros_like(gdt)
        vel_l = torch.where(dyn_l[:, None],
                            vel_l + torch.stack([zero, gdt, zero]), vel_l)

        # ---- 3. contacts (halo-exchange Jacobi) -------------------------
        cols = dict(stc, pos=pos_l, quat=quat_l, vel=vel_l, ang=ang_l,
                    dyn=dyn_l, solid=solid_l)
        full = _unpack(gather(_pack(cols, _POSE + _COLUMNS)),
                       _POSE + _COLUMNS, cols)
        st_l = {k: cols[k] for k, _ in _COLUMNS}
        st_f = {k: full[k] for k, _ in _COLUMNS}
        v_l, w_l, _, _ = local_rows_contact_solve(
            r0, rows, n, pos_l, quat_l, vel_l, ang_l,
            full["pos"], full["quat"], full["vel"], full["ang"],
            st_l, st_f, rep(st.ground_enabled), dt, solver_iterations,
            max_neighbors, group, aabb_margin=aabb_margin)

        # ---- 4. integrate local rows + world refresh --------------------
        moving = (dyn_l | kin_l)[:, None]
        pos_l = torch.where(moving, pos_l + v_l * dt, pos_l)
        quat_l = torch.where(moving, math3d.quat_integrate(quat_l, w_l, dt),
                             quat_l)
        v_l = torch.where(moving, v_l, 0.0)
        w_l = torch.where(moving, w_l, 0.0)

        # character visual offset (feet at the transform)
        vis_pos_l = pos_l
        if any_char:
            off = rep(st.char_half_height) + rep(st.char_radius)
            for s in range(c_slots):
                hit = ((char_entity[s] >= 0) & (safe[s] >= r0)
                       & (safe[s] < r0 + rows) & (rows_ar == rel[s]))
                lift = torch.stack([torch.zeros_like(off[s]), off[s],
                                    torch.zeros_like(off[s])])
                vis_pos_l = torch.where(hit[:, None], vis_pos_l - lift,
                                        vis_pos_l)

        if flat_hierarchy:
            world_l = math3d.mat_from_srt(scale_l, quat_l, vis_pos_l)
        else:
            # level-ordered propagation over gathered full views (repeated
            # on every rank; scene graphs are shallow against body count)
            world_f = update_world_matrices(
                gather(vis_pos_l), gather(quat_l), gather(scale_l),
                gather(loc(st.parent)), rep(st.level_nodes),
                gather(alive_l))
            world_l = world_f[r0:r0 + rows]

        # ---- 5. triggers (local columns of the [T, N] planes) -----------
        if any_trig:
            pos_f2, quat_f2 = gather(pos_l), gather(quat_l)
            te = rep(st.trig_entity)
            safe_te = te.clamp_min(0).to(torch.int64)
            tmn, tmx = sh.shape_aabb(
                pos_f2[safe_te], quat_f2[safe_te],
                rep(st.trig_shape).to(stc["shape_type"].dtype),
                rep(st.trig_size))
            emn, emx = sh.shape_aabb(pos_l, quat_l, stc["shape_type"],
                                     stc["size"])
            ov = sh.aabb_overlap(tmn[:, None], tmx[:, None], emn[None, :],
                                 emx[None, :])
            layer_ok = (
                ((rep(st.trig_layer)[:, None] & stc["mask"][None, :]) != 0)
                & ((stc["layer"][None, :] & rep(st.trig_mask)[:, None])
                   != 0))
            valid = ((te[:, None] >= 0) & trig_active[:, None]
                     & alive_l[None, :] & has_col_l[None, :]
                     & (te[:, None] != local_ids[None, :]) & layer_ok)
            now_ov = ov & valid
            enter = now_ov & ~trig_ov_l
            stay = now_ov & trig_ov_l
            exit_ = trig_ov_l & ~now_ov
            # a oneShot trigger deactivates on an Enter on any rank
            fired = ranks.sum_ranks(
                enter.any(dim=1).to(torch.int32), group) > 0
            new_active = trig_active & ~(rep(st.trig_one_shot) & fired)
        else:
            now_ov = trig_ov_l
            enter = stay = exit_ = torch.zeros_like(trig_ov_l)
            new_active = trig_active

        def wrap(a, like):
            return ranks.rewrap(a, like)

        new_state = tree_replace(
            state, pos=wrap(pos_l, state.pos), quat=wrap(quat_l, state.quat),
            lin_vel=wrap(v_l, state.lin_vel),
            ang_vel=wrap(w_l, state.ang_vel),
            char_vel_y=wrap(cvy_l, state.char_vel_y),
            char_on_ground=wrap(cog_l, state.char_on_ground),
            world=wrap(world_l, state.world),
            trigger_overlap=wrap(now_ov, state.trigger_overlap),
            trigger_active=wrap(new_active, state.trigger_active),
            time=wrap(rep(state.time) + dt, state.time),
            step_idx=wrap(rep(state.step_idx) + 1, state.step_idx))
        events = StepEvents(
            trigger_enter=wrap(enter, state.trigger_overlap),
            trigger_stay=wrap(stay, state.trigger_overlap),
            trigger_exit=wrap(exit_, state.trigger_overlap),
            contact_overflow=torch.zeros((), dtype=torch.int32, device=dev))
        return new_state, events

    return step
