"""Many worlds in lockstep: the flat block-diagonal step on one device.

Counterpart of the single-device part of
``banggameengine_tpu/parallel/manyworld.py``: :func:`replicate_state`,
:func:`replicate_input`, :func:`_flat_static` and
:func:`make_flat_many_world_step`.  W worlds of B entities run as ONE world
of W*B entities through ``physics_step(broadphase="static")``: every
world's solid bodies are each other's neighbors, fixed when the factory
builds the flat scene, and no neighbor list crosses a world block, so no
broadphase runs.  Characters read their own world's input row (slot w =
world w), and characters and triggers are masked to their world's block.

Not ported yet: the vmapped ``make_sharded_many_world_step``, the
auto-router ``make_many_world_step`` and the ``mesh`` (sharded) mode of
the flat step (ROADMAP queue 1, item 20).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from banggameengine_tpu_torch.engine import engine_step
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

    The returned function also carries ``flatten``, ``unflatten``,
    ``flat_step`` (one engine step of the flat world, with its events)
    and ``flat_static``.
    """
    if mesh is not None:
        raise NotImplementedError(
            "the sharded flat many-world step (mesh=...) is not ported "
            "yet: ROADMAP queue 1, item 20")
    w = num_worlds
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
        fs = flatten(bstate)
        for _ in range(num_steps):
            fs, _events = flat_step(fs, binp)
        return unflatten(fs)

    step.flatten = flatten
    step.unflatten = unflatten
    step.flat_step = flat_step
    step.flat_static = flat_static
    return step
