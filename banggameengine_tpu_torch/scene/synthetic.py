"""Procedural benchmark scenes (no asset files needed).

Counterpart of ``banggameengine_tpu/scene/synthetic.py``
:func:`build_falling_boxes` and :func:`build_demo_like`.  The scene is
drawn with numpy from the same ``default_rng(seed)`` in the same order, so
one seed gives the same scene as the JAX builder: positions and every
static field bit-equal, rotations equal to the last ulp of f32 sin/cos
(the demo world has no rotation: equal throughout).

The render scenes have no JAX counterpart (the JAX package renders the
demo scene from asset files): :func:`build_showcase_render` stands in for
the demo frame, :func:`build_box_render` draws a box world.  Both return
numpy arrays, so the same scene feeds the JAX package and the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from banggameengine_tpu_torch import math3d
from banggameengine_tpu_torch.ecs.transform import compute_levels
from banggameengine_tpu_torch.physics.config import PhysicsConfig
from banggameengine_tpu_torch.render.camera import Camera
from banggameengine_tpu_torch.scene.build import pack_render_scene
from banggameengine_tpu_torch.scene.textures import (
    make_checker_rgba8,
    make_white_rgba8,
)
from banggameengine_tpu_torch.state import (
    BODY_DYNAMIC,
    BODY_KINEMATIC,
    BODY_STATIC,
    COMP_CHARACTER,
    COMP_COLLIDER,
    COMP_RIGID_BODY,
    COMP_TRANSFORM,
    COMP_TRIGGER,
    LAYER_CHARACTER,
    SHAPE_BOX,
    SHAPE_CAPSULE,
    StaticScene,
    WorldState,
    make_world_state,
    tree_replace,
)


def _box_inertia_inv(mass, half):
    e = 2.0 * np.asarray(half, np.float64)
    i = mass / 12.0 * np.array(
        [e[1] ** 2 + e[2] ** 2, e[0] ** 2 + e[2] ** 2, e[0] ** 2 + e[1] ** 2]
    )
    return (1.0 / np.maximum(i, 1e-12)).astype(np.float32)


def build_falling_boxes(
    num_bodies: int,
    seed: int = 0,
    spread: float | None = None,
    config: PhysicsConfig | None = None,
    with_character: bool = False,
    with_trigger: bool = False,
    device: torch.device | str = "cuda",
) -> tuple[WorldState, StaticScene]:
    """A world of ``num_bodies`` dynamic unit boxes raining onto the ground
    plane (the stress scene), on ``device``.  Deterministic for a seed."""
    cfg = (config or PhysicsConfig()).sanitized()
    rng = np.random.default_rng(seed)
    extra = (1 if with_character else 0) + (1 if with_trigger else 0)
    n = max(8, int(np.ceil((num_bodies + extra) / 8.0)) * 8)

    alive = np.zeros(n, bool)
    comp = np.zeros(n, np.uint32)
    pos = np.zeros((n, 3), np.float32)
    euler = np.zeros((n, 3), np.float32)
    body_type = np.zeros(n, np.int8)
    shape_type = np.zeros(n, np.int8)
    size = np.zeros((n, 3), np.float32)
    inv_mass = np.zeros(n, np.float32)
    inv_inertia = np.zeros((n, 3), np.float32)
    friction = np.full(n, 0.5, np.float32)
    restitution = np.zeros(n, np.float32)
    layer = np.zeros(n, np.uint32)
    mask = np.zeros(n, np.uint32)

    if spread is None:
        # spacing so resting boxes roughly tile the ground one layer deep
        spread = max(4.0, 1.2 * np.sqrt(num_bodies))

    half = np.array([0.5, 0.5, 0.5], np.float32)
    inertia = _box_inertia_inv(1.0, half)
    # the draws stay one body at a time, in the JAX builder's order
    for i in range(num_bodies):
        pos[i] = (
            rng.uniform(-spread, spread),
            rng.uniform(2.0, 2.0 + 0.5 * num_bodies),
            rng.uniform(-spread, spread),
        )
        euler[i] = rng.uniform(-np.pi, np.pi, 3)
    boxes = slice(0, num_bodies)
    alive[boxes] = True
    comp[boxes] = COMP_TRANSFORM | COMP_COLLIDER | COMP_RIGID_BODY
    body_type[boxes] = BODY_DYNAMIC
    shape_type[boxes] = SHAPE_BOX
    size[boxes] = half
    inv_mass[boxes] = 1.0
    inv_inertia[boxes] = inertia
    layer[boxes] = 1
    mask[boxes] = 0xFFFFFFFF

    cursor = num_bodies
    characters = []
    if with_character:
        ci = cursor
        cursor += 1
        alive[ci] = True
        comp[ci] = COMP_TRANSFORM | COMP_COLLIDER | COMP_CHARACTER
        pos[ci] = (0.0, 7.0, -5.0)
        shape_type[ci] = SHAPE_CAPSULE
        size[ci] = (cfg.capsule_radius, cfg.capsule_height * 0.5, 0.0)
        body_type[ci] = BODY_KINEMATIC
        layer[ci] = LAYER_CHARACTER
        mask[ci] = 0xFFFFFFFF
        characters.append(ci)

    triggers = []
    if with_trigger:
        ti = cursor
        cursor += 1
        alive[ti] = True
        comp[ti] = COMP_TRANSFORM | COMP_TRIGGER
        pos[ti] = (5.0, 1.0, 5.0)
        triggers.append(ti)

    t_slots = max(1, len(triggers))
    trig_entity = np.full(t_slots, -1, np.int32)
    trig_entity[: len(triggers)] = triggers
    c_slots = max(1, len(characters))
    char_entity = np.full(c_slots, -1, np.int32)
    char_entity[: len(characters)] = characters
    parent = np.full(n, -1, np.int32)

    def t(a, dtype=None):
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)   # bit view: 0xFFFFFFFF -> -1
        return torch.as_tensor(a, dtype=dtype, device=device)

    def f32(v):
        return torch.full((), v, dtype=torch.float32, device=device)

    def f32_slots(v):
        return torch.full((c_slots,), v, dtype=torch.float32, device=device)

    static = StaticScene(
        parent=t(parent),
        level_nodes=t(compute_levels(parent, alive)),
        body_type=t(body_type),
        shape_type=t(shape_type),
        shape_size=t(size),
        inv_mass=t(inv_mass),
        inv_inertia_body=t(inv_inertia),
        friction=t(friction),
        restitution=t(restitution),
        layer=t(layer),
        mask=t(mask),
        trig_entity=t(trig_entity),
        trig_shape=t(np.full(t_slots, SHAPE_BOX, np.int8)),
        trig_size=t(np.tile(np.asarray([1.5, 1.5, 1.5], np.float32),
                            (t_slots, 1))),
        trig_layer=t(np.full(t_slots, 4, np.uint32)),
        trig_mask=t(np.full(t_slots, 0xFFFFFFFF, np.uint32)),
        trig_one_shot=t(np.zeros(t_slots, bool)),
        char_entity=t(char_entity),
        char_radius=f32_slots(cfg.capsule_radius),
        char_half_height=f32_slots(cfg.capsule_height * 0.5),
        char_walk_speed=f32_slots(cfg.walk_speed),
        char_jump_impulse=f32_slots(cfg.jump_impulse),
        gravity=f32(cfg.gravity),
        fixed_dt=f32(cfg.fixed_step),
        step_height=f32(cfg.step_height),
        max_slope_cos=f32(float(np.cos(np.deg2rad(cfg.max_slope_deg)))),
        ground_enabled=torch.ones((), dtype=torch.bool, device=device),
    )

    state = make_world_state(n, t_slots, device=device)
    state = tree_replace(
        state,
        alive=t(alive),
        comp_mask=t(comp),
        pos=t(pos),
        quat=math3d.quat_from_euler_xyz(t(euler)),
    )
    return state, static


def build_demo_like(config: PhysicsConfig | None = None,
                    device: torch.device | str = "cuda"
                    ) -> tuple[WorldState, StaticScene]:
    """The asset-free stand-in for the demo scene (the JAX builder's
    ``build_demo_like``, the same poses as ``assets/scenes/demo.json``): the
    capsule character at slot 0 (spawned at (0, 7, -5)), the checkpoint
    trigger at slot 1 ((5, 1, 5), half size 1.5) and the static ground box
    at slot 2 (half extents (50, 1, 50) at y = -0.01, friction 1)."""
    state, static = build_falling_boxes(0, config=config,
                                        with_character=True,
                                        with_trigger=True, device=device)
    gi = 2   # after the character (0) and the trigger (1)

    def at(a, value):
        a = a.clone()
        a[gi] = torch.as_tensor(value, dtype=a.dtype)
        return a

    state = tree_replace(
        state,
        alive=at(state.alive, True),
        comp_mask=at(state.comp_mask,
                     COMP_TRANSFORM | COMP_COLLIDER | COMP_RIGID_BODY),
        pos=at(state.pos, [0.0, -0.01, 0.0]))
    static = tree_replace(
        static,
        body_type=at(static.body_type, BODY_STATIC),
        shape_type=at(static.shape_type, SHAPE_BOX),
        shape_size=at(static.shape_size, [50.0, 1.0, 50.0]),
        friction=at(static.friction, 1.0),
        layer=at(static.layer, 1),
        mask=at(static.mask, -1))    # 0xFFFFFFFF as int32 bits
    return state, static


# ---------------------------------------------------------------------------
# render scenes
# ---------------------------------------------------------------------------

# the camera of the JAX package's render benchmarks (bench.py _render_setup)
BENCH_CAMERA_POS = (0.0, 4.0, -10.5)
BENCH_CAMERA_YAW = 3.14159 / 2
BENCH_CAMERA_PITCH = -0.12
# the 10k-box tick's camera: on the ground at the centre of the world,
# looking up into the falling boxes.  At step 200 most boxes are still
# falling (they start up to 5 km high) and few have landed, so this is
# where the frame holds the most boxes: ~1,700 in view against ~25 from
# the bench camera
TICK_CAMERA_POS = (0.0, 1.5, 0.0)
TICK_CAMERA_YAW_PITCH = (np.pi / 2, np.deg2rad(80.0))

# unit-cube faces (corner ids, outward normal), two triangles each
_CUBE_CORNERS = np.array(
    [[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
     [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float32)
_CUBE_FACES = (
    ([0, 3, 2, 1], [0, 0, -1]), ([4, 5, 6, 7], [0, 0, 1]),
    ([0, 1, 5, 4], [0, -1, 0]), ([3, 7, 6, 2], [0, 1, 0]),
    ([0, 4, 7, 3], [-1, 0, 0]), ([1, 2, 6, 5], [1, 0, 0]),
)
_QUAD_UV = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)


def _cube_template():
    """Unit cube (half extent 1) as a 36-corner soup: positions, normals,
    uvs (each face maps the whole [0, 1]^2)."""
    pos, nrm, uv = [], [], []
    for idx, n in _CUBE_FACES:
        for tri in ((0, 1, 2), (0, 2, 3)):
            for c in tri:
                pos.append(_CUBE_CORNERS[idx[c]])
                nrm.append(n)
                uv.append(_QUAD_UV[c])
    return (np.asarray(pos, np.float32), np.asarray(nrm, np.float32),
            np.asarray(uv, np.float32))


def _uv_sphere(stacks: int, slices: int):
    """Unit sphere as a corner soup: 2 * slices * (stacks - 1) triangles."""
    def point(i, j):
        th, ph = np.pi * i / stacks, 2.0 * np.pi * j / slices
        return (np.array([np.sin(th) * np.cos(ph), np.cos(th),
                          np.sin(th) * np.sin(ph)]),
                np.array([j / slices, i / stacks]))

    pos, uv = [], []
    for i in range(stacks):
        for j in range(slices):
            a, b = point(i, j), point(i, j + 1)
            c, d = point(i + 1, j + 1), point(i + 1, j)
            tris = ([(a, c, d)] if i == 0 else [(a, b, c)] if i == stacks - 1
                    else [(a, b, c), (a, c, d)])
            for tri in tris:
                for p, t in tri:
                    pos.append(p)
                    uv.append(t)
    pos = np.asarray(pos, np.float32)
    return pos, pos.copy(), np.asarray(uv, np.float32)


def _srt(scale, yaw, pos) -> np.ndarray:
    """World matrix T @ Ry(yaw) @ S, f32[4,4]."""
    c, s = np.cos(yaw), np.sin(yaw)
    m = np.eye(4)
    m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]) @ np.diag(scale)
    m[:3, 3] = pos
    return m.astype(np.float32)


def _noise_texture(rng, size, base, amp) -> np.ndarray:
    tex = np.empty((size, size, 4), np.float32)
    tex[..., :3] = np.asarray(base, np.float32) + rng.uniform(
        -amp, amp, (size, size, 3))
    tex[..., 3] = 255.0
    return np.clip(tex, 0, 255).astype(np.uint8)


@dataclasses.dataclass
class Showcase:
    """A render scene (numpy arrays of :class:`RenderScene`'s fields), its
    entities' world matrices f32[N,4,4] and the camera to render it with."""

    render: dict
    world: np.ndarray
    camera: Camera


def build_showcase_render(seed: int = 0, n_props: int = 40) -> Showcase:
    """A procedural stand-in for the demo frame, no asset files needed.

    - ground: a box of half extents (50, 1, 50) at y = -0.01 (the demo's
      pose), seeded 256x256 texture at uv scale 8; it crosses the near
      plane and is binned in the global list;
    - character stand-in: a UV sphere of 2,304 triangles (the demo's
      character mesh has 2,332) scaled to a 1 x 1.9 x 1 ellipsoid at
      (0, 2.94, -5), with a second texture;
    - ``n_props`` boxes of mixed materials (white texture with tints and
      spec colours, a checker) scattered in front of the camera;
    - the JAX package's render-benchmark camera.
    """
    rng = np.random.default_rng(seed)
    textures = [make_white_rgba8(),
                _noise_texture(rng, 256, (96, 140, 70), 40.0),
                _noise_texture(rng, 128, (200, 120, 90), 50.0),
                make_checker_rgba8()]
    # material rows: tint rgba, uv scale, spec color, texture
    materials = [
        ((1.0, 1.0, 1.0, 1.0), (1.0, 1.0), (1.0, 1.0, 1.0), 0),   # default
        ((0.9, 0.95, 0.85, 1.0), (8.0, 8.0), (0.2, 0.2, 0.2), 1),  # ground
        ((1.0, 1.0, 1.0, 1.0), (2.0, 1.0), (0.6, 0.6, 0.6), 2),    # character
        ((0.85, 0.25, 0.2, 1.0), (1.0, 1.0), (1.0, 1.0, 1.0), 0),
        ((0.2, 0.45, 0.9, 1.0), (1.0, 1.0), (0.3, 0.3, 0.8), 0),
        ((0.95, 0.8, 0.2, 1.0), (1.0, 1.0), (0.0, 0.0, 0.0), 0),
        ((1.0, 1.0, 1.0, 0.8), (3.0, 3.0), (1.0, 0.9, 0.8), 3),
    ]
    cube_pos, cube_nrm, cube_uv = _cube_template()
    sph_pos, sph_nrm, sph_uv = _uv_sphere(25, 48)

    entities = [  # (mesh, material, world matrix)
        ((cube_pos * np.float32([50, 1, 50]), cube_nrm, cube_uv), 1,
         _srt((1, 1, 1), 0.0, (0.0, -0.01, 0.0))),
        ((sph_pos * np.float32(1.2), sph_nrm, sph_uv), 2,
         _srt((1, 1, 1), 0.3, (0.0, 2.94, -5.0))),
    ]
    for _ in range(n_props):
        # small enough, and far enough from the camera, that every face
        # spans at most 4 x 4 tiles at 1080p: they bin as local triangles
        x, z = rng.uniform(-9.0, 9.0), rng.uniform(0.0, 24.0)
        half = rng.uniform(0.2, 0.45, 3).astype(np.float32)
        entities.append(((cube_pos * half, cube_nrm, cube_uv),
                         int(rng.integers(3, len(materials))),
                         _srt((1, 1, 1), rng.uniform(-np.pi, np.pi),
                              (x, 0.99 + half[1], z))))
    n = max(8, -(-len(entities) // 8) * 8)
    world = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    soup = ([], [], [], [], [])
    for e, ((p, nm, uv), mat, m) in enumerate(entities):
        world[e] = m
        for part, a in zip(soup, (p, nm, uv,
                                  np.full(len(p), e, np.int32),
                                  np.full(len(p) // 3, mat, np.int32))):
            part.append(a)
    v_pos, v_nrm, v_uv, v_entity, tri_material = (np.concatenate(a)
                                                  for a in soup)
    render = pack_render_scene(
        v_pos, v_nrm, v_uv, v_entity, tri_material, textures,
        mat_base_tint=[m[0] for m in materials],
        mat_uv_scale=[m[1] for m in materials],
        mat_spec_params=[(32.0, 0.35)] * len(materials),
        mat_spec_color=[m[2] for m in materials],
        mat_tex=[m[3] for m in materials], capacity=n)

    camera = Camera()
    camera.position[:] = BENCH_CAMERA_POS
    camera.set_yaw_pitch(BENCH_CAMERA_YAW, BENCH_CAMERA_PITCH)
    return Showcase(render=render, world=world, camera=camera)


def build_box_render(static: StaticScene) -> dict:
    """Render arrays for a box world (:func:`build_falling_boxes`): every box
    body gets the 12 triangles of its box, ``v_entity`` = body index, and
    one of four tinted white materials.  No ground mesh: the stress world's
    ground is the implicit plane."""
    shape = static.shape_type.cpu().numpy()
    half = static.shape_size.cpu().numpy()
    bodies = np.nonzero(shape == SHAPE_BOX)[0].astype(np.int32)
    cube_pos, cube_nrm, cube_uv = _cube_template()
    v_pos = (cube_pos[None] * half[bodies][:, None, :]).reshape(-1, 3)
    tints = [(1.0, 1.0, 1.0, 1.0), (0.9, 0.35, 0.25, 1.0),
             (0.3, 0.55, 0.9, 1.0), (0.95, 0.85, 0.3, 1.0)]
    return pack_render_scene(
        v_pos, np.tile(cube_nrm, (len(bodies), 1)),
        np.tile(cube_uv, (len(bodies), 1)),
        np.repeat(bodies, len(cube_pos)),
        np.repeat(1 + bodies % 4, len(cube_pos) // 3),
        [make_white_rgba8()],
        mat_base_tint=[tints[0]] + tints,
        mat_uv_scale=[(1.0, 1.0)] * 5,
        mat_spec_params=[(32.0, 0.35)] * 5,
        mat_spec_color=[(1.0, 1.0, 1.0)] * 5,
        mat_tex=[0] * 5, capacity=static.capacity)
