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
  Characters read their own world's input row (slot w = world w), and
  characters and triggers are masked to their world's block.

:func:`make_many_world_step` picks the flat layout and falls back to the
vmapped one only when the flat factory refuses the scene.  With a world
mesh (:func:`make_world_mesh`, a ``DeviceMesh`` over the ranks of the
process group) the world axis is sharded: each rank steps its own worlds
(:func:`shard_batched`), and the only collective is the metrics' sum.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from banggameengine_tpu_torch.engine import engine_step
from banggameengine_tpu_torch.parallel import ranks
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
    **physics_kwargs,
):
    """The vmapped lockstep many-worlds step.

    Returns ``step(batched_state, batched_input) -> batched_state`` (or
    ``(state, metrics)`` with ``with_metrics``): ``num_steps`` steps of
    ``torch.func.vmap`` over :func:`engine.engine_step`, the static scene
    unbatched and its census computed here, once, as the JAX factory does.
    State and input carry a leading world axis.  With ``mesh`` (a world
    mesh) they are :func:`shard_batched` DTensors and each rank steps its
    own worlds; ``with_metrics`` means are over every world (a sum over
    the ranks, divided by W).  ``world_minor=True`` moves the world axis
    last at the boundary and vmaps over it; the result is the same.
    """
    kwargs = {**scene_census(static), **physics_kwargs}
    ax = -1 if world_minor else 0

    def one_world(state_fields, input_fields):
        out, _events = engine_step(
            WorldState(*state_fields), InputFrame(*input_fields), static,
            solver_iterations, **kwargs)
        return tuple(getattr(out, name) for name in _STATE_FIELDS)

    vstep = torch.func.vmap(one_world, in_dims=(ax, ax), out_dims=ax)
    group = None if mesh is None else mesh.get_group()

    def step(bstate: WorldState, binp: InputFrame):
        num_worlds = bstate.alive.shape[0]
        sf = tuple(ranks.local(getattr(bstate, n)) for n in _STATE_FIELDS)
        inf = tuple(ranks.local(getattr(binp, n)) for n in _INPUT_FIELDS)
        if world_minor:
            sf = tuple(a.movedim(0, -1) for a in sf)
            inf = tuple(a.movedim(0, -1) for a in inf)
        for _ in range(num_steps):
            sf = vstep(sf, inf)
        if world_minor:
            sf = tuple(a.movedim(-1, 0) for a in sf)
        out = WorldState(*(ranks.rewrap(a, getattr(bstate, n))
                           for n, a in zip(_STATE_FIELDS, sf)))
        if not with_metrics:
            return out
        m = world_metrics(WorldState(*sf))
        if group is None:
            return out, {k: v.mean() for k, v in m.items()}
        return out, {k: ranks.sum_ranks(v.sum(), group) / num_worlds
                     for k, v in m.items()}

    return step


def _flat_static(static: StaticScene, num_worlds: int, comp_mask_1w):
    """Tile one world's StaticScene into a [W*B]-entity block-diagonal
    scene, with the static intra-world neighbor lists and the per-entity
    world group ids.  Host-side numpy, once per factory call; returns
    ``(flat_static, nb_idx int32[W*B, K], nb_val bool[W*B, K], group
    int32[W*B], char_cand int32[W, B], shifts)`` on the static scene's
    device, where ``shifts`` is the sorted tuple of partner offsets
    (partner id - row id) that the block topology produces.
    ``comp_mask_1w`` is one world's component mask: its solid boxes and
    capsules, characters excepted, are the bodies that meet."""
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
    k = max(int(len(sol)) - 1, 1)
    loc_idx = np.zeros((b, k), np.int32)
    loc_val = np.zeros((b, k), bool)
    for i in sol:
        others = [j for j in sol if j != i]
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
    one-step calls equal one N-step call.

    The neighbor topology is fixed at build time: bodies spawned or
    despawned later do not join or leave the contact graph (dead bodies
    are still masked out by ``alive``).

    With ``mesh`` (a world mesh) the world axis is sharded: each rank
    flattens its own W/D worlds (the local rows of :func:`shard_batched`
    DTensors) and runs this same step on them, with no collective.
    ``num_worlds`` must then divide by the mesh size (ValueError
    otherwise).

    The returned function also carries ``flatten``, ``unflatten``,
    ``flat_step`` (one engine step of the flat world, with its events)
    and ``flat_static``.
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
    flat_static, nb_idx, nb_val, group, char_cand, shifts = _flat_static(
        static, w, comp_mask_1w)
    kwargs = {**scene_census(static), **physics_kwargs}
    kwargs.update(broadphase="static", static_neighbors=(nb_idx, nb_val),
                  group=group, char_candidates=char_cand,
                  solver_block_size=b, solver_block_shifts=shifts)
    dev = static.parent.device
    di = torch.arange(w, device=dev)
    # Contact features encode partner ids: pair features are (partner + 1)
    # * FEAT_STRIDE + slot (>= FEAT_STRIDE), ground features bare slot ids
    # (< FEAT_STRIDE).  The flat partner is w*B + partner, so the
    # per-world <-> flat remap is an offset of w*B*FEAT_STRIDE on pair
    # features, and the warm-start cache survives dispatch boundaries.
    feat_off = (torch.arange(w, dtype=torch.int32, device=dev) * b
                * FEAT_STRIDE)[:, None, None]

    def flat_step(fs: WorldState, binp: InputFrame):
        return engine_step(fs, binp, flat_static, solver_iterations,
                           **kwargs)

    def flatten(s: WorldState) -> WorldState:
        f = {}
        for name in _ROW_FIELDS:
            a = getattr(s, name)
            f[name] = a.reshape((n,) + a.shape[2:])
        cf = s.contact_feat
        f["contact_feat"] = torch.where(
            cf >= FEAT_STRIDE, cf + feat_off, cf).reshape(n, -1)
        ov = torch.zeros((w, t1, w, b), dtype=torch.bool, device=dev)
        ov[di, :, di, :] = s.trigger_overlap
        f["trigger_overlap"] = ov.reshape(w * t1, n)
        f["trigger_active"] = s.trigger_active.reshape(w * t1)
        # lockstep: every world shares the clock
        f["time"] = s.time[0]
        f["step_idx"] = s.step_idx[0]
        return WorldState(**f)

    def unflatten(fs: WorldState) -> WorldState:
        f = {}
        for name in _ROW_FIELDS:
            a = getattr(fs, name)
            f[name] = a.reshape((w, b) + a.shape[1:])
        cf = fs.contact_feat.reshape(w, b, -1)
        f["contact_feat"] = torch.where(cf >= FEAT_STRIDE, cf - feat_off, cf)
        f["trigger_overlap"] = fs.trigger_overlap.reshape(
            w, t1, w, b)[di, :, di, :]
        f["trigger_active"] = fs.trigger_active.reshape(w, t1)
        f["time"] = fs.time.expand(w).clone()
        f["step_idx"] = fs.step_idx.expand(w).clone()
        return WorldState(**f)

    def step(bstate: WorldState, binp: InputFrame) -> WorldState:
        fs = flatten(ranks.map_fields(ranks.local, bstate))
        binp_l = ranks.map_fields(ranks.local, binp)
        for _ in range(num_steps):
            fs, _events = flat_step(fs, binp_l)
        out = unflatten(fs)
        if mesh is None:
            return out
        return WorldState(**{
            n: ranks.rewrap(getattr(out, n), getattr(bstate, n))
            for n in _STATE_FIELDS})

    step.flatten = flatten
    step.unflatten = unflatten
    step.flat_step = flat_step
    step.flat_static = flat_static
    return step


def make_many_world_step(
    static: StaticScene,
    mesh,
    comp_mask_1w,
    num_worlds: int,
    num_steps: int = 1,
    verbose: bool = True,
    **physics_kwargs,
):
    """Auto-routing many-world factory: ``(step, layout)``.

    The flat block-diagonal layout first, on one rank (``"flat"``) or
    sharded over the world mesh (``"flat-sharded"``, each rank its own
    W/D worlds); the vmapped layout (``"vmapped"``) only when the flat
    builder refuses the scene with ``ValueError`` (world count not
    divisible by the mesh), and then with a printed line.  Any other
    failure propagates.  ``mesh=None`` is one process.
    """
    try:
        step = make_flat_many_world_step(
            static, num_worlds, comp_mask_1w, num_steps=num_steps,
            mesh=mesh, **physics_kwargs)
        layout = ("flat" if mesh is None or mesh.size() == 1
                  else "flat-sharded")
        return step, layout
    except ValueError as e:
        if verbose:
            print(f"[manyworld] flat layout unavailable "
                  f"({type(e).__name__}: {e}); using vmapped")
    step = make_sharded_many_world_step(
        static, mesh, num_steps=num_steps, **physics_kwargs)
    return step, "vmapped"
