"""Scenes made from a configuration's parameters and a seed, on the device.

Each scene function returns the scene's raw fields: ``(static, state)``, two
dicts of tensors keyed by the field names of the state types (the port's
``StaticScene`` and ``WorldState`` and the reference's frozen copies have
the same fields).  Either side wraps them in its own classes, so both start from the same
tensors and neither derives them.
Random draws use one ``torch.Generator`` on the device, in a few large
calls.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from portbench.reference import math3d
from portbench.reference.ecs.transform import compute_levels
from portbench.reference.state import (
    BODY_DYNAMIC,
    BODY_KINEMATIC,
    COMP_CHARACTER,
    COMP_COLLIDER,
    COMP_RIGID_BODY,
    COMP_TRANSFORM,
    COMP_TRIGGER,
    LAYER_CHARACTER,
    SHAPE_BOX,
    SHAPE_CAPSULE,
    make_world_state,
)


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for one purpose (``stream``) of a run:
    the seed (any whole number) and the purpose hashed to 63 bits."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63))
    return g


def uniform(g, shape, lo, hi, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def box_inv_inertia(mass: float, half) -> list[float]:
    """Bullet's ``btBoxShape::calculateLocalInertia``, inverted."""
    e = [2.0 * float(h) for h in half]
    i = [mass / 12.0 * (e[1] ** 2 + e[2] ** 2),
         mass / 12.0 * (e[0] ** 2 + e[2] ** 2),
         mass / 12.0 * (e[0] ** 2 + e[1] ** 2)]
    return [1.0 / max(v, 1e-12) for v in i]


def _static(n: int, physics: dict, device, **fields) -> dict:
    """A static scene of ``n`` entities: every field zero or empty but
    those given (numpy or tensors); one trigger and one character slot,
    unused unless given."""
    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def f32(v):
        return torch.full((), float(v), dtype=torch.float32, device=device)

    out = dict(
        parent=t(np.full(n, -1), torch.int32),
        level_nodes=t(np.zeros((1, 1)), torch.int32),
        body_type=t(np.zeros(n), torch.int8),
        shape_type=t(np.zeros(n), torch.int8),
        shape_size=t(np.zeros((n, 3)), torch.float32),
        inv_mass=t(np.zeros(n), torch.float32),
        inv_inertia_body=t(np.zeros((n, 3)), torch.float32),
        friction=t(np.full(n, physics["friction"]), torch.float32),
        restitution=t(np.full(n, physics["restitution"]), torch.float32),
        layer=t(np.zeros(n), torch.int32),
        mask=t(np.zeros(n), torch.int32),
        trig_entity=t([-1], torch.int32),
        trig_shape=t([SHAPE_BOX], torch.int8),
        trig_size=t([[1.5, 1.5, 1.5]], torch.float32),
        trig_layer=t([4], torch.int32),
        trig_mask=t([-1], torch.int32),
        trig_one_shot=t([False], torch.bool),
        char_entity=t([-1], torch.int32),
        char_radius=t([physics["capsule_radius"]], torch.float32),
        char_half_height=t([physics["capsule_height"] * 0.5],
                           torch.float32),
        char_walk_speed=t([physics["walk_speed"]], torch.float32),
        char_jump_impulse=t([physics["jump_impulse"]], torch.float32),
        gravity=f32(physics["gravity"]),
        fixed_dt=f32(physics["fixed_dt"]),
        step_height=f32(physics["step_height"]),
        max_slope_cos=f32(math.cos(math.radians(physics["max_slope_deg"]))),
        ground_enabled=torch.ones((), dtype=torch.bool, device=device),
    )
    for k, v in fields.items():
        out[k] = (v.to(device=device, dtype=out[k].dtype)
                  if torch.is_tensor(v) else t(v, out[k].dtype))
    return out


def _state(n: int, device, alive, comp, pos, quat) -> dict:
    state = dataclasses.asdict(make_world_state(n, 1, device=device))
    state.update(alive=alive, comp_mask=comp, pos=pos, quat=quat)
    return state


def box_lattice(scene: dict, physics: dict, seed: int, device):
    """Bullet's ``BenchmarkDemo::createTest1``: ``size`` x ``size`` boxes a
    layer, ``layers`` layers, half extent ``half_extent``; on the lattice
    of pitch 2 x half extent + ``spacing``, layer k at ``start_height`` +
    k x pitch and shifted by k x ``layer_shift`` x spacing x (size - 1)
    towards -x and -z; each lattice point p placed at ``origin`` +
    ``scale`` * p (the source's ``bpos``).  The seed moves each box in x
    and z by up to ``jitter_m`` and turns it about y by up to
    ``jitter_yaw_deg``."""
    size, layers = int(scene["size"]), int(scene["layers"])
    h, gap = float(scene["half_extent"]), float(scene["spacing"])
    pitch = 2.0 * h + gap
    n = size * size * layers
    k = torch.arange(layers, device=device, dtype=torch.float32)
    ij = torch.arange(size, device=device, dtype=torch.float32)
    offset = (-size * pitch * 0.5
              - k * float(scene["layer_shift"]) * gap * (size - 1))
    x = offset[:, None, None] + ij[None, None, :] * pitch    # [k, j, i]
    z = offset[:, None, None] + ij[None, :, None] * pitch
    y = float(scene["start_height"]) + k[:, None, None] * pitch
    pos = torch.stack(torch.broadcast_tensors(x, y, z), -1).reshape(n, 3)
    pos = (torch.tensor(scene["origin"], dtype=torch.float32, device=device)
           + torch.tensor(scene["scale"], dtype=torch.float32,
                          device=device) * pos)
    g = generator(seed, device, stream=1)
    jit = float(scene["jitter_m"])
    pos = pos + torch.stack([
        uniform(g, n, -jit, jit, device), torch.zeros(n, device=device),
        uniform(g, n, -jit, jit, device)], -1)
    yaw_max = math.radians(float(scene["jitter_yaw_deg"]))
    euler = torch.zeros((n, 3), device=device)
    euler[:, 1] = uniform(g, n, -yaw_max, yaw_max, device)
    quat = math3d.quat_from_euler_xyz(euler)

    mass = float(scene["mass"])
    half = [h, h, h]
    alive = torch.ones(n, dtype=torch.bool, device=device)
    static = _static(
        n, physics, device,
        level_nodes=compute_levels(np.full(n, -1, np.int32),
                                   np.ones(n, bool)),
        body_type=np.full(n, BODY_DYNAMIC),
        shape_type=np.full(n, SHAPE_BOX),
        shape_size=np.tile(np.float32(half), (n, 1)),
        inv_mass=np.full(n, 1.0 / mass),
        inv_inertia_body=np.tile(np.float32(box_inv_inertia(mass, half)),
                                 (n, 1)),
        layer=np.ones(n), mask=np.full(n, -1))
    comp = torch.full((n,), COMP_TRANSFORM | COMP_COLLIDER | COMP_RIGID_BODY,
                      dtype=torch.int32, device=device)
    return static, _state(n, device, alive, comp, pos, quat)


def rollout_world(scene: dict, physics: dict, device):
    """One world of the lockstep rollout: ``boxes`` dynamic boxes (poses
    set per world by :func:`rollout_poses`), the capsule character and the
    checkpoint trigger at the demo scene's poses; entity capacity rounded
    up to a multiple of 8.  Returns ``(static, state)`` of that world."""
    nb = int(scene["boxes"])
    n = max(8, -(-(nb + 2) // 8) * 8)
    ci, ti = nb, nb + 1
    half = [float(scene["box_half_extent"])] * 3
    mass = float(scene["box_mass"])
    body_type = np.zeros(n)
    body_type[:nb] = BODY_DYNAMIC
    body_type[ci] = BODY_KINEMATIC
    shape_type = np.zeros(n)
    shape_type[:nb] = SHAPE_BOX
    shape_type[ci] = SHAPE_CAPSULE
    size = np.zeros((n, 3), np.float32)
    size[:nb] = half
    size[ci] = (physics["capsule_radius"], physics["capsule_height"] * 0.5,
                0.0)
    inv_mass = np.zeros(n)
    inv_mass[:nb] = 1.0 / mass
    inertia = np.zeros((n, 3), np.float32)
    inertia[:nb] = box_inv_inertia(mass, half)
    layer = np.zeros(n)
    layer[:nb] = 1
    layer[ci] = LAYER_CHARACTER
    mask = np.zeros(n)
    mask[:ci + 1] = -1
    alive = np.zeros(n, bool)
    alive[:ti + 1] = True
    static = _static(
        n, physics, device,
        level_nodes=compute_levels(np.full(n, -1, np.int32), alive),
        body_type=body_type, shape_type=shape_type, shape_size=size,
        inv_mass=inv_mass, inv_inertia_body=inertia, layer=layer, mask=mask,
        trig_entity=[ti], trig_size=[scene["trigger_half_extents"]],
        char_entity=[ci])
    comp = np.zeros(n, np.int64)
    comp[:nb] = COMP_TRANSFORM | COMP_COLLIDER | COMP_RIGID_BODY
    comp[ci] = COMP_TRANSFORM | COMP_COLLIDER | COMP_CHARACTER
    comp[ti] = COMP_TRANSFORM | COMP_TRIGGER
    pos = np.zeros((n, 3), np.float32)
    pos[ci] = scene["character_pos"]
    pos[ti] = scene["trigger_pos"]
    quat = torch.zeros((n, 4), device=device)
    quat[:, 3] = 1.0
    state = _state(n, device, torch.as_tensor(alive, device=device),
                   torch.as_tensor(comp, dtype=torch.int32, device=device),
                   torch.as_tensor(pos, device=device), quat)
    return static, state


def rollout_poses(scene: dict, worlds: int, seed: int, device):
    """Every world's box poses, drawn from the seed: centres uniform in
    [-spread, spread] x [y_min, y_max] x [-spread, spread], Euler angles
    uniform in [-pi, pi].  Returns (pos f32[W, boxes, 3], quat f32[W,
    boxes, 4])."""
    nb = int(scene["boxes"])
    g = generator(seed, device, stream=2)
    s = float(scene["spread"])
    lo = torch.tensor([-s, scene["y_min"], -s], device=device)
    hi = torch.tensor([s, scene["y_max"], s], device=device)
    pos = lo + (hi - lo) * torch.rand((worlds, nb, 3), generator=g,
                                      device=device)
    euler = uniform(g, (worlds, nb, 3), -math.pi, math.pi, device)
    return pos, math3d.quat_from_euler_xyz(euler)


def fields(obj) -> dict:
    """A dataclass of tensors as a dict (no copy)."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
