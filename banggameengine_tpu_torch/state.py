"""Core state containers: WorldState, StaticScene, InputFrame, StepEvents.

PyTorch counterpart of ``banggameengine_tpu/state.py``: the same field
names, shapes and meanings, held as plain dataclasses of tensors.  One
difference: the JAX package's ``uint32`` bit fields (``comp_mask``,
``layer``, ``mask``, ``trig_layer``, ``trig_mask``) are ``int32`` here with
the same bit pattern (``0xFFFFFFFF`` is ``-1``), because torch's ``uint32``
supports few operations.  Only bitwise ``&`` and ``!= 0`` are applied to
them, which read the same on both.

Component bits mirror the reference engine's ``Scene.cpp:11-16``:
Transform=0, MeshRenderer=1, PhysicsCharacter=2, Collider=3, RigidBody=4,
Trigger=5.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

# Component mask bits (== reference Scene.cpp:11-16)
COMP_TRANSFORM = 1 << 0
COMP_MESH_RENDERER = 1 << 1
COMP_CHARACTER = 1 << 2
COMP_COLLIDER = 1 << 3
COMP_RIGID_BODY = 1 << 4
COMP_TRIGGER = 1 << 5

# Body types (== reference PhysicsComponents.h:22-26 enum order)
BODY_NONE = 0
BODY_STATIC = 1
BODY_DYNAMIC = 2
BODY_KINEMATIC = 3

# Shape types (== reference PhysicsComponents.h:8-11: Box, Capsule)
SHAPE_NONE = 0
SHAPE_BOX = 1
SHAPE_CAPSULE = 2

# Collision layers (== reference PhysicsSystem.cpp:36-38)
LAYER_WORLD = 1 << 0
LAYER_CHARACTER = 1 << 1
LAYER_TRIGGER = 1 << 2

CONTACT_CACHE_SLOTS = 12   # == physics.step.CONTACT_BUDGET
FEAT_STRIDE = 64           # feature id stride per partner (> narrowphase K)

Tensor = torch.Tensor


@dataclasses.dataclass
class WorldState:
    """Per-world mutable simulation state (capacity N entities, T trigger
    slots, CB contact-cache slots)."""

    # --- entity/transform ---
    alive: Tensor          # bool[N]
    comp_mask: Tensor      # int32[N] component bits (uint32 bit pattern)
    pos: Tensor            # f32[N,3] local position
    quat: Tensor           # f32[N,4] local rotation [x,y,z,w]
    scale: Tensor          # f32[N,3] local scale
    world: Tensor          # f32[N,4,4] world matrices (refreshed each step)

    # --- rigid-body dynamics ---
    lin_vel: Tensor        # f32[N,3]
    ang_vel: Tensor        # f32[N,3]

    # --- character controller ---
    char_vel_y: Tensor     # f32[N]
    char_on_ground: Tensor  # bool[N]

    # --- triggers ---
    # bool[T, N] for one world; a batch of W worlds bool[W, T, B]; the flat
    # many-world layout its per-world blocks bool[W*T, B] (row w*T + t is
    # world w's slot t against world w's B entities)
    trigger_overlap: Tensor
    trigger_active: Tensor   # bool[T]

    # --- persistent contact cache (warm starting) ---
    contact_feat: Tensor   # int32[N, CB] feature ids, -1 = empty
    contact_imp: Tensor    # f32[N, CB, 3] (lambda_n, lambda_t1, lambda_t2)

    # --- bookkeeping ---
    time: Tensor           # f32[]
    step_idx: Tensor       # int32[]

    @property
    def capacity(self) -> int:
        return self.alive.shape[-1]


@dataclasses.dataclass
class StaticScene:
    """Per-scene topology and parameters, built once on the host."""

    parent: Tensor         # int32[N] (-1 = root)
    level_nodes: Tensor    # int32[L, M] entity ids per depth level, -1 padded

    body_type: Tensor      # int8[N] BODY_*
    shape_type: Tensor     # int8[N] SHAPE_*
    shape_size: Tensor     # f32[N,3] box half-extents | capsule (r, hh, 0)
    inv_mass: Tensor       # f32[N]
    inv_inertia_body: Tensor  # f32[N,3]
    friction: Tensor       # f32[N]
    restitution: Tensor    # f32[N]
    layer: Tensor          # int32[N] (uint32 bit pattern)
    mask: Tensor           # int32[N] (uint32 bit pattern)

    trig_entity: Tensor    # int32[T] (-1 empty)
    trig_shape: Tensor     # int8[T]
    trig_size: Tensor      # f32[T,3]
    trig_layer: Tensor     # int32[T] (uint32 bit pattern)
    trig_mask: Tensor      # int32[T] (uint32 bit pattern)
    trig_one_shot: Tensor  # bool[T]

    char_entity: Tensor    # int32[C] (-1 empty)
    char_radius: Tensor    # f32[C]
    char_half_height: Tensor  # f32[C]
    char_walk_speed: Tensor   # f32[C]
    char_jump_impulse: Tensor  # f32[C]

    gravity: Tensor        # f32[] signed Y acceleration
    fixed_dt: Tensor       # f32[]
    step_height: Tensor    # f32[]
    max_slope_cos: Tensor  # f32[]

    ground_enabled: Tensor  # bool[] implicit static ground plane at y=0

    @property
    def capacity(self) -> int:
        return self.parent.shape[-1]

    @property
    def num_trigger_slots(self) -> int:
        return self.trig_entity.shape[-1]

    @property
    def num_char_slots(self) -> int:
        return self.char_entity.shape[-1]


@dataclasses.dataclass
class InputFrame:
    """One tick of player/camera input: scalars drive every character
    slot; [C] vectors one slot each (the flat many-world step's [W]
    batch, one row per world)."""

    move_forward: Tensor  # f32[] or f32[C]
    move_right: Tensor    # f32[] or f32[C]
    jump: Tensor          # bool[] or bool[C]
    sprint: Tensor        # bool[] or bool[C]
    cam_yaw: Tensor       # f32[] or f32[C]

    @staticmethod
    def zero(device: torch.device | str = "cuda") -> "InputFrame":
        f = torch.zeros((), dtype=torch.float32, device=device)
        b = torch.zeros((), dtype=torch.bool, device=device)
        return InputFrame(move_forward=f, move_right=f.clone(), jump=b,
                          sprint=b.clone(), cam_yaw=f.clone())


@dataclasses.dataclass
class StepEvents:
    """Events produced by one step, as dense tensors."""

    # the shape of the state's trigger_overlap: bool[T, N] for one world,
    # bool[W*T, B] for the flat many-world layout
    trigger_enter: Tensor
    trigger_stay: Tensor
    trigger_exit: Tensor
    # contact-slot candidates dropped by the per-body budgets this step
    contact_overflow: Tensor  # int32[]


def make_world_state(capacity: int, num_trigger_slots: int,
                     contact_slots: int = CONTACT_CACHE_SLOTS,
                     device: torch.device | str = "cuda") -> WorldState:
    """Fresh empty world with the given entity/trigger capacities."""
    n, t = capacity, num_trigger_slots
    f32 = dict(dtype=torch.float32, device=device)
    quat = torch.zeros((n, 4), **f32)
    quat[:, 3] = 1.0
    return WorldState(
        alive=torch.zeros((n,), dtype=torch.bool, device=device),
        comp_mask=torch.zeros((n,), dtype=torch.int32, device=device),
        pos=torch.zeros((n, 3), **f32),
        quat=quat,
        scale=torch.ones((n, 3), **f32),
        world=torch.eye(4, **f32).repeat(n, 1, 1),
        lin_vel=torch.zeros((n, 3), **f32),
        ang_vel=torch.zeros((n, 3), **f32),
        char_vel_y=torch.zeros((n,), **f32),
        char_on_ground=torch.zeros((n,), dtype=torch.bool, device=device),
        trigger_overlap=torch.zeros((t, n), dtype=torch.bool, device=device),
        trigger_active=torch.ones((t,), dtype=torch.bool, device=device),
        contact_feat=torch.full((n, contact_slots), -1, dtype=torch.int32,
                                device=device),
        contact_imp=torch.zeros((n, contact_slots, 3), **f32),
        time=torch.zeros((), **f32),
        step_idx=torch.zeros((), dtype=torch.int32, device=device),
    )


def tree_replace(obj: Any, **updates: Any) -> Any:
    """``dataclasses.replace``, under the JAX package's name."""
    return dataclasses.replace(obj, **updates)
