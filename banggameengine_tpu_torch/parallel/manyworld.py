"""Many worlds in lockstep: the vmapped and flat steps, their router and
the world-axis mesh.

Counterpart of ``banggameengine_tpu/parallel/manyworld.py``.  Two layouts
step W worlds of B entities in lockstep:

- the vmapped step (:func:`make_sharded_many_world_step`):
  ``torch.func.vmap`` of the single-world :func:`engine.engine_step` over a
  leading world axis, the static scene unbatched;
- the flat block-diagonal step (:func:`make_flat_many_world_step`): the W
  worlds run as ONE world of W*B entities through
  ``physics_step(broadphase="static")``.  Every world's solid bodies are
  each other's neighbors, fixed when the factory builds the flat scene,
  and no neighbor list crosses a world block, so no broadphase runs.
  Characters read their own world's input row (slot w = world w) and are
  masked to their world's block.  The trigger planes are per-world
  blocks, bool[W*T, B] (row w*T + t: world w's slot t against its own B
  entities), so no trigger pair crosses a world and no plane of the step
  grows with the square of W.

Joints (:mod:`physics.joints`) run on the flat layout only: its factory
tiles one world's joint table over the worlds and steps them on the
static route, and the vmapped layout refuses them.

:func:`make_many_world_step` picks the flat layout and falls back to the
vmapped one only when the flat factory refuses the scene.  The batched
state that both take and return carries the trigger planes as bool[W, T,
B]; a single world's state as bool[T, N].  With a world
mesh (:func:`make_world_mesh`, a ``DeviceMesh`` over the ranks of the
process group) the world axis is sharded: each rank steps its own worlds
(:func:`shard_batched`), and the only collective is the metrics' sum.
On the card every step is a captured :class:`graphs.Program`, with a mesh
or without, over this rank's local worlds.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from banggameengine_tpu_torch import graphs
from banggameengine_tpu_torch.engine import engine_step
from banggameengine_tpu_torch.parallel import ranks
from banggameengine_tpu_torch.physics import joints as jt
from banggameengine_tpu_torch.physics.step import scene_census
from banggameengine_tpu_torch.state import (
    COMP_COLLIDER,
    FEAT_STRIDE,
    SHAPE_BOX,
    SHAPE_CAPSULE,
    InputFrame,
    StaticScene,
    WorldState,
)
from banggameengine_tpu_torch.utils.profiling import span

WORLD_AXIS = "world"

# per-world state fields that flatten by a plain reshape [W, B, ...] ->
# [W*B, ...]
_ROW_FIELDS = ("alive", "comp_mask", "pos", "quat", "scale", "world",
               "lin_vel", "ang_vel", "char_vel_y", "char_on_ground",
               "contact_imp")
# static fields tiled once per world: per-entity and per-slot attributes
_TILED_FIELDS = ("body_type", "shape_type", "shape_size", "inv_mass",
                 "inv_inertia_body", "friction", "restitution", "layer",
                 "mask", "trig_shape", "trig_size", "trig_layer",
                 "trig_mask", "trig_one_shot", "char_radius",
                 "char_half_height", "char_walk_speed", "char_jump_impulse")
# static entity ids, offset by each world's block start (-1 stays -1)
_ID_FIELDS = ("parent", "trig_entity", "char_entity")


def _replicate(obj, num_worlds: int):
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).expand(
            (num_worlds,) + getattr(obj, f.name).shape).clone()
        for f in dataclasses.fields(obj)})


def replicate_state(state: WorldState, num_worlds: int) -> WorldState:
    """Stack one world into a [W, ...] batch."""
    return _replicate(state, num_worlds)


def replicate_input(inp: InputFrame, num_worlds: int) -> InputFrame:
    """Stack one input into a [W] batch (one row per world)."""
    return _replicate(inp, num_worlds)


def make_world_mesh(devices=None, device_type: str = "cuda"):
    """1-D mesh over the ranks of the initialised process group, its dim
    named ``"world"``.  ``devices`` is None or the group's ranks: a mesh
    position is a process (one a card under NCCL; gloo ranks on the CPU
    with ``device_type="cpu"``)."""
    return ranks.make_mesh(WORLD_AXIS, device_type, devices)


def shard_batched(tree, mesh):
    """Place a [W, ...]-batched dataclass (the whole batch, the same on
    every rank) with its leading world axis sharded over the mesh: each
    rank keeps its own W/D worlds as the local part of a ``Shard(0)``
    DTensor.  No collective."""
    from torch.distributed.tensor import Shard

    return ranks.map_fields(
        lambda x: ranks.distribute(x, mesh, Shard(0)), tree)


def world_metrics(state: WorldState) -> dict:
    """Per-world scalar diagnostics of a [W, ...] batch, reduced across
    worlds by the caller: kinetic energy ``0.5 sum |v|^2`` and the mean
    height of the live entities."""
    ke = 0.5 * (state.lin_vel ** 2).sum(dim=(-2, -1))
    return {
        "mean_kinetic_energy": ke,
        "mean_height": (state.pos[..., 1] * state.alive).sum(dim=-1)
        / state.alive.sum(dim=-1).clamp_min(1),
    }


_STATE_FIELDS = tuple(f.name for f in dataclasses.fields(WorldState))
_INPUT_FIELDS = tuple(f.name for f in dataclasses.fields(InputFrame))


def make_sharded_many_world_step(
    static: StaticScene,
    mesh=None,
    num_steps: int = 1,
    solver_iterations: int = 10,
    with_metrics: bool = False,
    world_minor: bool = False,
    joints=None,
    **physics_kwargs,
):
    """The vmapped lockstep many-worlds step (no joints: ``joints`` raises
    ValueError, since they run on the flat layout).

    Returns ``step(batched_state, batched_input) -> batched_state`` (or
    ``(state, metrics)`` with ``with_metrics``): ``num_steps`` steps of
    ``torch.func.vmap`` over :func:`engine.engine_step`, the static scene
    unbatched and its census computed here, once, as the JAX factory does.
    State and input carry a leading world axis.  With ``mesh`` (a world
    mesh) they are :func:`shard_batched` DTensors and each rank steps its
    own worlds; ``with_metrics`` means are over every world (a sum over
    the ranks, divided by W).  ``world_minor=True`` moves the world axis
    last at the boundary and vmaps over it; the result is the same.

    On the card a call replays one graph of the vmapped step
    ``num_steps`` times on this rank's worlds, the state donated as in
    JAX: the returned state is the graph's buffers, valid until the next
    call.  The metrics are a second graph that reads those buffers in
    place, its all-reduce over the mesh inside it.
    """
    if joints is not None:
        raise ValueError("the vmapped many-world layout takes no joints; "
                         "they run on the flat layout "
                         "(make_flat_many_world_step)")
    kwargs = {**scene_census(static), **physics_kwargs}
    ax = -1 if world_minor else 0

    def one_world(state_fields, input_fields):
        out, _events = engine_step(
            WorldState(*state_fields), InputFrame(*input_fields), static,
            solver_iterations, **kwargs)
        return tuple(getattr(out, name) for name in _STATE_FIELDS)

    vstep = torch.func.vmap(one_world, in_dims=(ax, ax), out_dims=ax)
    program = graphs.Program(lambda sf, inf: (vstep(sf, inf),),
                             donate=True, name="vmapped_step")
    group = None if mesh is None else mesh.get_group()

    def means(sf, num_worlds: int) -> dict:
        m = world_metrics(WorldState(*sf))
        if group is None:
            return {k: v.mean() for k, v in m.items()}
        return {k: ranks.sum_ranks(v.sum(), group) / num_worlds
                for k, v in m.items()}

    # the state is the step's donated buffers, read in place (without a
    # step, the caller's own tensors, which must not become buffers)
    metrics = graphs.Program(means, by_ref=(0,) if num_steps >= 1 else (),
                             name="world_metrics")

    def step(bstate: WorldState, binp: InputFrame):
        num_worlds = bstate.alive.shape[0]
        sf = tuple(ranks.local(getattr(bstate, n)) for n in _STATE_FIELDS)
        inf = tuple(ranks.local(getattr(binp, n)) for n in _INPUT_FIELDS)
        if world_minor:
            sf = tuple(a.movedim(0, -1) for a in sf)
            inf = tuple(a.movedim(0, -1) for a in inf)
        if num_steps >= 1:
            (sf,) = program(sf, inf, times=num_steps)
        if world_minor:
            sf = tuple(a.movedim(-1, 0) for a in sf)
        out = WorldState(*(ranks.rewrap(a, getattr(bstate, n))
                           for n, a in zip(_STATE_FIELDS, sf)))
        if not with_metrics:
            return out
        return out, metrics(sf, num_worlds)

    step.program = program
    step.metrics = metrics
    return step


def _flat_static(static: StaticScene, num_worlds: int, comp_mask_1w,
                 joints=None):
    """Tile one world's StaticScene into a [W*B]-entity block-diagonal
    scene, with the static intra-world neighbor lists and the per-entity
    world group ids.  Host-side numpy, once per factory call; returns
    ``(flat_static, nb_idx int32[W*B, K], nb_val bool[W*B, K], group
    int32[W*B], char_cand int32[W, B], shifts)`` on the static scene's
    device, where ``shifts`` is the sorted tuple of partner offsets
    (partner id - row id) that the block topology produces.
    ``comp_mask_1w`` is one world's component mask: its solid boxes and
    capsules, characters excepted, are the bodies that meet, where their
    layers and masks meet both ways and no joint of ``joints`` (one
    world's) joins them.  A list is as wide as the most partners a solid
    body has: with joints possibly 0 (the dense narrowphase then takes
    the ground alone), without at least 1, since the box contacts'
    kernel takes no empty list."""
    dev = static.parent.device
    w = num_worlds
    b = static.capacity
    n = w * b
    host = {f.name: getattr(static, f.name).cpu().numpy()
            for f in dataclasses.fields(static)}
    offs = np.arange(w, dtype=np.int32) * b

    def off_slots(ent):
        out = ent[None, :] + np.where(ent[None, :] >= 0, offs[:, None], 0)
        return out.reshape(-1).astype(np.int32)

    flat = {name: np.tile(host[name], (w,) + (1,) * (host[name].ndim - 1))
            for name in _TILED_FIELDS}
    flat.update({name: off_slots(host[name]) for name in _ID_FIELDS})
    # the level-ordered hierarchy tiles like every per-entity array:
    # level_nodes [L, M] becomes [L, W*M], each level holding every
    # world's nodes (-1 padding stays -1)
    ln = host["level_nodes"]
    flat_ln = np.where(ln[None, :, :] >= 0,
                       ln[None, :, :] + offs[:, None, None], -1)
    flat["level_nodes"] = np.transpose(flat_ln, (1, 0, 2)).reshape(
        ln.shape[0], w * ln.shape[1]).astype(np.int32)
    flat_static = dataclasses.replace(
        static, **{k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                   for k, v in flat.items()})

    # the solid shapes of one world (the bodies the contact pipeline
    # sees): characters are ghosts and never reach the solver
    ce = host["char_entity"]
    is_char = np.zeros(b, bool)
    is_char[ce[ce >= 0]] = True
    st = host["shape_type"]
    comp = np.asarray(comp_mask_1w.cpu() if torch.is_tensor(comp_mask_1w)
                      else comp_mask_1w)
    solid = (((comp & COMP_COLLIDER) != 0)
             & ((st == SHAPE_BOX) | (st == SHAPE_CAPSULE)) & ~is_char)
    sol = np.where(solid)[0]
    layer, mask = host["layer"], host["mask"]
    meet = (~np.eye(b, dtype=bool)
            & ((layer[:, None] & mask[None, :]) != 0)
            & ((layer[None, :] & mask[:, None]) != 0))
    if joints is not None:
        meet &= ~jt.jointed_pairs(joints, b).cpu().numpy()
    partners = {i: [j for j in sol if meet[i, j]] for i in sol}
    k = max([len(p) for p in partners.values()] + [int(joints is None)])
    loc_idx = np.zeros((b, k), np.int32)
    loc_val = np.zeros((b, k), bool)
    for i, others in partners.items():
        loc_idx[i, :len(others)] = others
        loc_val[i, :len(others)] = True
    nb_idx = (loc_idx[None] + offs[:, None, None]).reshape(n, k)
    nb_val = np.tile(loc_val, (w, 1))
    group = np.repeat(np.arange(w, dtype=np.int32), b)
    # character slot w's obstacle candidates: its own world's block
    char_cand = offs[:, None] + np.arange(b, dtype=np.int32)[None, :]
    rows = np.arange(b, dtype=np.int64)[:, None]
    shifts = tuple(sorted({int(d) for d in (
        loc_idx[loc_val] - np.broadcast_to(rows, loc_idx.shape)[loc_val])}))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return (flat_static, t(nb_idx), t(nb_val), t(group), t(char_cand),
            shifts)


def make_flat_many_world_step(
    static: StaticScene,
    num_worlds: int,
    comp_mask_1w,
    num_steps: int = 1,
    solver_iterations: int = 10,
    mesh=None,
    joints=None,
    **physics_kwargs,
):
    """Flat block-diagonal lockstep many-worlds step, on the static
    scene's device.

    Returns ``step(batched_state [W, B, ...], batched_input [W]) ->
    batched_state``: ``num_steps`` steps of the W worlds in one call, run
    as one flat world of W*B entities.  ``comp_mask_1w`` is one world's
    component mask (it picks the solid bodies at build time).  The flat
    scene, the neighbor lists and the scene census are built here, once;
    a call only flattens, steps and unflattens, with no host
    synchronisation.  The contact cache survives the flatten/unflatten
    seam (its feature ids are remapped by an integer offset), so N
    one-step calls equal one N-step call.  The flat state carries the
    trigger overlap as per-world blocks bool[W*T, B], a reshape of the
    batched bool[W, T, B]; the flat step sweeps each world's triggers
    against its own B entities, and its events take the same shape.

    The neighbor topology is fixed at build time: bodies spawned or
    despawned later do not join or leave the contact graph (dead bodies
    are still masked out by ``alive``).

    With ``mesh`` (a world mesh) the world axis is sharded: each rank
    flattens its own W/D worlds (the local rows of :func:`shard_batched`
    DTensors) and runs this same step on them, with no collective.
    ``num_worlds`` must then divide by the mesh size (ValueError
    otherwise).

    On the card, with a mesh or without, a call is three graphs on this
    rank's worlds: flatten, one flat step replayed ``num_steps`` times on
    the flat state, and unflatten back into the batched state's buffers,
    donated as in JAX: the returned state is those buffers, valid until
    the next call.

    The lists hold each solid body's partners in its world whose layers
    and masks meet its own both ways (the JAX package's take every solid
    pair).  With ``joints`` (one world's
    :class:`physics.joints.JointSet`) the factory tiles the joint table
    over the worlds once (body ids offset by each world's block start)
    and leaves the jointed pairs out of the lists too; the flat step
    takes the static route's joints (the dense narrowphase and the
    unified solve over the lists).  A call is then ``step(bstate, binp,
    joint_state, command=None) -> (bstate, joint_state)``: the batched
    joints' impulses ``joint_state.impulse`` [W, J, 7] (from
    :func:`physics.joints.make_joint_state` with ``num_worlds``) are
    flattened to [W*J, 7] and back with the state and donated with it,
    and ``joint_state.limit_rows`` counts the limit rows at their bound
    over this rank's worlds in the last step.  ``command`` f32[W, J]
    drives the hinges' motors, one row a world, held for the call's steps
    (the flat step reads it as [W*J]); a set with motors needs it, one
    without takes none.  One program serves both: its carry holds the
    joint state, or None.

    The returned function also carries ``flatten``, ``unflatten``,
    ``flat_step`` (one engine step of the flat world, with its events,
    and with joints ``flat_step(fs, binp, joint_state, command)``),
    ``flat_static`` and ``flat_joints``.
    """
    n_dev = 1 if mesh is None else mesh.size()
    if num_worlds % n_dev:
        raise ValueError(
            f"flat many-world sharding needs num_worlds ({num_worlds}) "
            f"divisible by the mesh size ({n_dev})")
    w = num_worlds // n_dev              # worlds on this rank
    b = static.capacity
    t1 = static.num_trigger_slots
    n = w * b
    if joints is not None and joints.lin_damping.shape[0] != b:
        raise ValueError(f"the joint set has {joints.lin_damping.shape[0]} "
                         f"bodies, the world {b}")
    flat_static, nb_idx, nb_val, group, char_cand, _ = _flat_static(
        static, w, comp_mask_1w, joints)
    kwargs = {**scene_census(static), **physics_kwargs}
    # one world is one group: no mask (and its plane bool[T, B] is square)
    kwargs.update(broadphase="static", static_neighbors=(nb_idx, nb_val),
                  group=group if w > 1 else None, char_candidates=char_cand)
    dev = static.parent.device
    flat_joints = None if joints is None else _flat_joints(joints, w, b)
    j = 0 if joints is None else joints.num_joints
    # Contact features encode partner ids: pair features are (partner + 1)
    # * FEAT_STRIDE + slot (>= FEAT_STRIDE), ground features bare slot ids
    # (< FEAT_STRIDE).  The flat partner is w*B + partner, so the
    # per-world <-> flat remap is an offset of w*B*FEAT_STRIDE on pair
    # features, and the warm-start cache survives dispatch boundaries.
    feat_off = (torch.arange(w, dtype=torch.int32, device=dev) * b
                * FEAT_STRIDE)[:, None, None]

    def flat_step(fs: WorldState, binp: InputFrame, fjs=None, command=None):
        if flat_joints is None:
            return engine_step(fs, binp, flat_static, solver_iterations,
                               **kwargs)
        return engine_step(fs, binp, flat_static, solver_iterations,
                           joints=flat_joints, joint_state=fjs,
                           motor_command=command, **kwargs)

    def enter(carry):
        """The batched (state, joint state) as the flat one."""
        s, js = carry
        with span("manyworld.flatten", dev):
            f = {}
            for name in _ROW_FIELDS:
                a = getattr(s, name)
                f[name] = a.reshape((n,) + a.shape[2:])
            cf = s.contact_feat
            f["contact_feat"] = torch.where(
                cf >= FEAT_STRIDE, cf + feat_off, cf).reshape(n, -1)
            f["trigger_overlap"] = s.trigger_overlap.reshape(w * t1, b)
            f["trigger_active"] = s.trigger_active.reshape(w * t1)
            # lockstep: every world shares the clock
            f["time"] = s.time[0]
            f["step_idx"] = s.step_idx[0]
            return WorldState(**f), (None if js is None else jt.JointState(
                impulse=js.impulse.reshape(w * j, jt.ROWS),
                limit_rows=js.limit_rows))

    def leave(carry):
        """The flat (state, joint state) as the batched one."""
        fs, fjs = carry
        with span("manyworld.unflatten", dev):
            f = {}
            for name in _ROW_FIELDS:
                a = getattr(fs, name)
                f[name] = a.reshape((w, b) + a.shape[1:])
            cf = fs.contact_feat.reshape(w, b, -1)
            f["contact_feat"] = torch.where(cf >= FEAT_STRIDE,
                                            cf - feat_off, cf)
            f["trigger_overlap"] = fs.trigger_overlap.reshape(w, t1, b)
            f["trigger_active"] = fs.trigger_active.reshape(w, t1)
            f["time"] = fs.time.expand(w).clone()
            f["step_idx"] = fs.step_idx.expand(w).clone()
            return WorldState(**f), (None if fjs is None else jt.JointState(
                impulse=fjs.impulse.reshape(w, j, jt.ROWS),
                limit_rows=fjs.limit_rows))

    def body(carry, binp, command):
        fs, fjs = carry
        out = flat_step(fs, binp, fjs,
                        None if command is None else command.reshape(-1))
        return ((out[0], None if fjs is None else out[2]),)

    program = graphs.Program(body, donate=True, enter=enter, leave=leave,
                             name="flat_many_world_step")

    def step(bstate: WorldState, binp: InputFrame, joint_state=None,
             command=None):
        if (joint_state is None) != (joints is None):
            raise ValueError("a step with joints takes their joint_state, "
                             "one without takes none")
        if num_steps >= 1:
            local = (ranks.map_fields(ranks.local, bstate),
                     None if joints is None
                     else ranks.map_fields(ranks.local, joint_state))
            ((out, js),) = program(
                local, ranks.map_fields(ranks.local, binp),
                None if command is None else ranks.local(command),
                times=num_steps)
            out = ranks.rewrap_fields(out, bstate)
            if joints is not None:
                js = ranks.rewrap_fields(js, joint_state)
        else:
            out, js = bstate, joint_state
        return out if joints is None else (out, js)

    step.flat_step = flat_step
    step.flatten = lambda s: enter((s, None))[0]
    step.unflatten = lambda fs: leave((fs, None))[0]
    step.flat_static = flat_static
    step.flat_joints = flat_joints
    step.program = program
    return step


def _flat_joints(joints: jt.JointSet, w: int, b: int) -> jt.JointSet:
    """One world's joint table tiled over ``w`` worlds of ``b`` bodies:
    body ids offset by each world's block start, the per-body rows of the
    impulse table renumbered for W*J joints."""
    j = joints.num_joints

    def tile(x):
        if not torch.is_tensor(x):
            return x
        return x.repeat((w,) + (1,) * (x.dim() - 1))

    offs = torch.arange(w, dtype=torch.int32,
                        device=joints.body_a.device).repeat_interleave(j)
    rows = joints.body_rows.to(torch.int64)             # [b, JB]
    world = torch.arange(w, device=rows.device)[:, None, None]
    # a side j -> w*J + j, b side J + j -> W*J + w*J + j, none -> 2*W*J
    flat_rows = torch.where(rows < j, world * j + rows,
                            torch.where(rows < 2 * j,
                                        w * j + world * j + rows - j,
                                        2 * w * j))
    fields = {f.name: tile(getattr(joints, f.name))
              for f in dataclasses.fields(joints)}
    fields.update(body_a=joints.body_a.repeat(w) + offs * b,
                  body_b=joints.body_b.repeat(w) + offs * b,
                  body_rows=flat_rows.reshape(w * b, -1).to(torch.int32))
    return jt.JointSet(**fields)


def make_many_world_step(
    static: StaticScene,
    mesh,
    comp_mask_1w,
    num_worlds: int,
    num_steps: int = 1,
    verbose: bool = True,
    joints=None,
    **physics_kwargs,
):
    """Auto-routing many-world factory: ``(step, layout)``.

    The flat block-diagonal layout first, on one rank (``"flat"``) or
    sharded over the world mesh (``"flat-sharded"``, each rank its own
    W/D worlds); the vmapped layout (``"vmapped"``) only when the flat
    builder refuses the scene with ``ValueError`` (world count not
    divisible by the mesh), and then with a printed line.  Any other
    failure propagates.  ``mesh=None`` is one process.  ``joints`` (one
    world's) go to the flat factory, whose step then takes and returns
    the joints' state and the motors' commands
    (:func:`make_flat_many_world_step`); the vmapped layout refuses them
    with ValueError.
    """
    try:
        step = make_flat_many_world_step(
            static, num_worlds, comp_mask_1w, num_steps=num_steps,
            mesh=mesh, joints=joints, **physics_kwargs)
        layout = ("flat" if mesh is None or mesh.size() == 1
                  else "flat-sharded")
        return step, layout
    except ValueError as e:
        if verbose:
            print(f"[manyworld] flat layout unavailable "
                  f"({type(e).__name__}: {e}); using vmapped")
    step = make_sharded_many_world_step(
        static, mesh, num_steps=num_steps, joints=joints, **physics_kwargs)
    return step, "vmapped"
