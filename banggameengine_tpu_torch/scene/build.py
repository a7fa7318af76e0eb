"""Scene build: a parsed scene file and its assets -> the device state.

Counterpart of ``banggameengine_tpu/scene/build.py``: :func:`build_scene`
instantiates a :class:`~banggameengine_tpu_torch.scene.schema.SceneDesc`
into the fixed-capacity arrays of :class:`StaticScene`, :class:`WorldState`
and :class:`RenderScene` (the same 21 fields as the JAX package's, as
tensors), with the same per-entity rules: component bits, clamped collider
sizes, Bullet's box inertia (a capsule's through its enclosing box), the
auto-attached ``"cj"`` character on the character layer, trigger and
character slots, the level table padded for runtime lifecycle.  The
initial quaternions and world matrices come from the port's ``math3d``
and ``ecs/transform``.  The render scene's head (materials, MTL
materials, texture ids, each entity's mesh expanded per submesh with its
material resolved) feeds :func:`pack_render_scene`, the tail (edge
dedupe, padding the triangle count to a multiple of 128, power-of-two
square texture pages, the ``[T, S, S, 16]`` texel-quad pack and its
channel-major ``[16, T*S*S]`` copy, entity AABBs), which the procedural
scenes of :mod:`banggameengine_tpu_torch.scene.synthetic` share.
``BuiltScene.spawn``, ``despawn`` and ``reparent`` edit the built scene at
run time (:mod:`banggameengine_tpu_torch.ecs.lifecycle`).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from banggameengine_tpu_torch import math3d
from banggameengine_tpu_torch.ecs import lifecycle
from banggameengine_tpu_torch.ecs.transform import (
    compute_levels,
    update_world_matrices,
)
from banggameengine_tpu_torch.physics.config import PhysicsConfig
from banggameengine_tpu_torch.scene.obj_loader import MeshData
from banggameengine_tpu_torch.scene.resources import ResourceManager
from banggameengine_tpu_torch.scene.schema import MaterialDesc, SceneDesc
from banggameengine_tpu_torch.state import (
    BODY_DYNAMIC,
    BODY_KINEMATIC,
    BODY_STATIC,
    COMP_CHARACTER,
    COMP_COLLIDER,
    COMP_MESH_RENDERER,
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

log = logging.getLogger("SceneBuild")

_BODY_TYPE_MAP = {"static": BODY_STATIC, "dynamic": BODY_DYNAMIC,
                  "kinematic": BODY_KINEMATIC}
_SHAPE_MAP = {"box": SHAPE_BOX, "capsule": SHAPE_CAPSULE}

Tensor = torch.Tensor


@dataclasses.dataclass
class RenderScene:
    """Device-side draw soup: per-instance triangle soup plus material and
    texture tables, materials already resolved per triangle."""

    v_pos: Tensor          # f32[V,3] object-space positions
    v_nrm: Tensor          # f32[V,3]
    v_uv: Tensor           # f32[V,2]
    v_entity: Tensor       # int32[V] owning entity (world matrix source)
    tri_material: Tensor   # int32[V/3]
    tri_valid: Tensor      # bool[V/3] (padding mask)
    mat_base_tint: Tensor  # f32[M,4]
    mat_uv_scale: Tensor   # f32[M,2]
    mat_spec_params: Tensor  # f32[M,2] (shininess, intensity)
    mat_spec_color: Tensor   # f32[M,3]
    mat_tex: Tensor        # int32[M] texture id
    textures: Tensor       # uint8[T,S,S,4], square power-of-two pages
    tex_size: Tensor       # int32[T,2] (w, h) actual
    # uint8[T,S,S,16]: RGBA of texels (y,x), (y,x+1), (y+1,x), (y+1,x+1)
    textures_quad: Tensor
    textures_quad_t: Tensor  # uint8[16, T*S*S] the same, channel-major
    ent_aabb_min: Tensor   # f32[N,3] object-space AABB per entity
    ent_aabb_max: Tensor   # f32[N,3]
    ent_has_mesh: Tensor   # bool[N]
    edge_pos: Tensor       # f32[E,2,3] deduplicated mesh edges
    edge_entity: Tensor    # int32[E]
    edge_valid: Tensor     # bool[E]


@dataclasses.dataclass
class BuiltScene:
    """Everything produced by one scene load (a host container).  The
    procedural scenes fill only the first three fields."""

    static: StaticScene
    initial_state: WorldState
    render: RenderScene
    logical_ids: dict[str, int] = dataclasses.field(default_factory=dict)
    entity_names: list[str] = dataclasses.field(default_factory=list)
    config: PhysicsConfig | None = None
    counts: dict[str, int] = dataclasses.field(default_factory=dict)

    def find_entity(self, logical_id: str) -> int:
        """-1 if absent (the reference's ``FindEntityByLogicalId``)."""
        return self.logical_ids.get(logical_id, -1)

    def spawn(self, state, **kwargs):
        """Create an entity at run time; see :func:`ecs.lifecycle.spawn`.
        Returns (new_state, entity_id); writes ``self.static`` in place."""
        return lifecycle.spawn(self, state, **kwargs)

    def despawn(self, state, entity: int):
        """Destroy an entity at run time; returns the new WorldState."""
        return lifecycle.despawn(self, state, entity)

    def reparent(self, state, entity: int, new_parent) -> None:
        """Re-attach an entity under a new parent (local transform kept)."""
        lifecycle.reparent(self, state, entity, new_parent)


def _dedupe_edges(v_pos: np.ndarray, v_entity: np.ndarray):
    """Mesh edges once per (entity, quantized endpoint pair), in first-seen
    order, as the JAX builder does."""
    rounded = np.round(v_pos, 4).tolist()
    edge_map: dict = {}
    for t in range(len(v_pos) // 3):
        ent = int(v_entity[3 * t])
        for i, j in ((0, 1), (1, 2), (2, 0)):
            ka, kb = tuple(rounded[3 * t + i]), tuple(rounded[3 * t + j])
            key = (ent, min(ka, kb), max(ka, kb))
            if key not in edge_map:
                edge_map[key] = (3 * t + i, 3 * t + j, ent)
    if not edge_map:
        return (np.zeros((1, 2, 3), np.float32), np.zeros(1, np.int32),
                np.zeros(1, bool))
    ends = np.asarray([(a, b) for a, b, _ in edge_map.values()], np.int64)
    edge_pos = v_pos[ends].astype(np.float32)                   # [E,2,3]
    edge_entity = np.asarray([e for _, _, e in edge_map.values()], np.int32)
    return edge_pos, edge_entity, np.ones(len(edge_entity), bool)


def _texture_pages(tex_list: list[np.ndarray]):
    """Pad every texture to one power-of-two square page and build the
    wrap-correct 2x2 texel-quad pack."""
    max_dim = max((max(t.shape[0], t.shape[1]) for t in tex_list), default=1)
    s = 1
    while s < max_dim:
        s *= 2
    tex_arr = np.zeros((len(tex_list), s, s, 4), np.uint8)
    tex_quad = np.zeros((len(tex_list), s, s, 16), np.uint8)
    tex_size = np.zeros((len(tex_list), 2), np.int32)
    for i, t in enumerate(tex_list):
        h, w = t.shape[0], t.shape[1]
        tex_arr[i, :h, :w] = t
        tex_size[i] = (w, h)
        xp = (np.arange(w) + 1) % w
        yp = (np.arange(h) + 1) % h
        tex_quad[i, :h, :w, 0:4] = t
        tex_quad[i, :h, :w, 4:8] = t[:, xp]
        tex_quad[i, :h, :w, 8:12] = t[yp]
        tex_quad[i, :h, :w, 12:16] = t[yp][:, xp]
    return tex_arr, tex_size, tex_quad


def pack_render_scene(
    v_pos: np.ndarray,         # f32[V,3] object-space corners, 3 per triangle
    v_nrm: np.ndarray,         # f32[V,3]
    v_uv: np.ndarray,          # f32[V,2]
    v_entity: np.ndarray,      # int32[V]
    tri_material: np.ndarray,  # int32[V/3]
    textures: list[np.ndarray],  # uint8[h,w,4] each
    mat_base_tint: np.ndarray,   # f32[M,4]
    mat_uv_scale: np.ndarray,    # f32[M,2]
    mat_spec_params: np.ndarray,  # f32[M,2]
    mat_spec_color: np.ndarray,   # f32[M,3]
    mat_tex: np.ndarray,          # int32[M]
    capacity: int,                # entity count N
) -> dict[str, np.ndarray]:
    """The 21 :class:`RenderScene` arrays, as numpy, from a triangle soup.

    Entity AABBs span each entity's own vertices; an entity without
    triangles has ``ent_has_mesh`` False and a zero AABB."""
    v_pos = np.asarray(v_pos, np.float32)
    v_nrm = np.asarray(v_nrm, np.float32)
    v_uv = np.asarray(v_uv, np.float32)
    v_entity = np.asarray(v_entity, np.int32)
    tri_material = np.asarray(tri_material, np.int32)

    ent_has_mesh = np.zeros(capacity, bool)
    ent_aabb_min = np.zeros((capacity, 3), np.float32)
    ent_aabb_max = np.zeros((capacity, 3), np.float32)
    ents = np.unique(v_entity) if len(v_pos) else np.zeros(0, np.int32)
    if ents.size:
        ent_has_mesh[ents] = True
        lo = np.full((capacity, 3), np.inf, np.float32)
        hi = np.full((capacity, 3), -np.inf, np.float32)
        np.minimum.at(lo, v_entity, v_pos)
        np.maximum.at(hi, v_entity, v_pos)
        ent_aabb_min[ents] = lo[ents]
        ent_aabb_max[ents] = hi[ents]
    if len(tri_material) == 0:          # one degenerate triangle, as JAX's
        v_pos = np.zeros((3, 3), np.float32)
        v_nrm = np.tile(np.array([[0, 1, 0]], np.float32), (3, 1))
        v_uv = np.zeros((3, 2), np.float32)
        v_entity = np.zeros(3, np.int32)
        tri_material = np.zeros(1, np.int32)

    edge_pos, edge_entity, edge_valid = _dedupe_edges(v_pos, v_entity)

    # pad the triangle count to a multiple of 128
    n_tri = len(tri_material)
    pad_tri = (-n_tri) % 128
    tri_valid = np.ones(n_tri, bool)
    if pad_tri:
        v_pos = np.concatenate([v_pos, np.zeros((pad_tri * 3, 3), np.float32)])
        v_nrm = np.concatenate(
            [v_nrm, np.tile(np.array([[0, 1, 0]], np.float32),
                            (pad_tri * 3, 1))])
        v_uv = np.concatenate([v_uv, np.zeros((pad_tri * 3, 2), np.float32)])
        v_entity = np.concatenate([v_entity, np.zeros(pad_tri * 3, np.int32)])
        tri_material = np.concatenate(
            [tri_material, np.zeros(pad_tri, np.int32)])
        tri_valid = np.concatenate([tri_valid, np.zeros(pad_tri, bool)])

    tex_arr, tex_size, tex_quad = _texture_pages(textures)
    return dict(
        v_pos=v_pos, v_nrm=v_nrm, v_uv=v_uv, v_entity=v_entity,
        tri_material=tri_material, tri_valid=tri_valid,
        mat_base_tint=np.asarray(mat_base_tint, np.float32),
        mat_uv_scale=np.asarray(mat_uv_scale, np.float32),
        mat_spec_params=np.asarray(mat_spec_params, np.float32),
        mat_spec_color=np.asarray(mat_spec_color, np.float32),
        mat_tex=np.asarray(mat_tex, np.int32),
        textures=tex_arr, tex_size=tex_size, textures_quad=tex_quad,
        textures_quad_t=np.ascontiguousarray(tex_quad.reshape(-1, 16).T),
        ent_aabb_min=ent_aabb_min, ent_aabb_max=ent_aabb_max,
        ent_has_mesh=ent_has_mesh,
        edge_pos=edge_pos, edge_entity=edge_entity, edge_valid=edge_valid,
    )


def _box_inertia_inv(mass: float, half: np.ndarray) -> np.ndarray:
    e = 2.0 * half
    i = mass / 12.0 * np.array(
        [e[1] ** 2 + e[2] ** 2, e[0] ** 2 + e[2] ** 2, e[0] ** 2 + e[1] ** 2],
        np.float64,
    )
    return np.where(i > 0, 1.0 / np.maximum(i, 1e-12), 0.0).astype(np.float32)


def _capsule_inertia_inv(mass: float, radius: float,
                         half_height: float) -> np.ndarray:
    # Bullet approximates a capsule's inertia by its bounding box
    half = np.array([radius, half_height + radius, radius], np.float64)
    return _box_inertia_inv(mass, half)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)   # bit view: 0xFFFFFFFF -> -1
    return torch.as_tensor(a, device=device)


def build_scene(
    desc: SceneDesc,
    resources: ResourceManager,
    config: PhysicsConfig | None = None,
    capacity: int | None = None,
    auto_character_id: str = "cj",
    max_trigger_slots: int | None = None,
    level_headroom: int = 2,
    device: torch.device | str = "cuda",
) -> BuiltScene:
    """Instantiate a parsed scene into tensors on ``device``.

    ``auto_character_id``: the reference attaches a character controller
    to the entity with this logical id on scene load; None disables it."""
    cfg = (config or PhysicsConfig()).sanitized()
    ents = desc.entities
    n_real = len(ents)
    n = capacity or max(8, int(np.ceil(n_real / 8.0)) * 8)
    if n < n_real:
        raise ValueError(f"capacity {n} < {n_real} entities")

    logical_ids: dict[str, int] = {}
    names: list[str] = []
    for i, e in enumerate(ents):
        logical_ids[e.logical_id] = i
        names.append(e.name)

    alive = np.zeros(n, bool)
    comp_mask = np.zeros(n, np.uint32)
    pos = np.zeros((n, 3), np.float32)
    euler = np.zeros((n, 3), np.float32)
    scale = np.ones((n, 3), np.float32)
    parent = np.full(n, -1, np.int32)

    body_type = np.zeros(n, np.int8)
    shape_type = np.zeros(n, np.int8)
    shape_size = np.zeros((n, 3), np.float32)
    inv_mass = np.zeros(n, np.float32)
    inv_inertia = np.zeros((n, 3), np.float32)
    friction = np.full(n, 0.5, np.float32)
    restitution = np.zeros(n, np.float32)
    layer = np.zeros(n, np.uint32)
    mask = np.zeros(n, np.uint32)

    triggers: list[int] = []
    characters: list[int] = []

    for i, e in enumerate(ents):
        alive[i] = True
        comp_mask[i] |= COMP_TRANSFORM
        pos[i] = e.transform.position
        euler[i] = e.transform.rotation_euler
        scale[i] = e.transform.scale
        if e.parent is not None:
            parent[i] = logical_ids.get(e.parent, -1)
            if parent[i] < 0:
                log.warning("entity '%s' parent '%s' not found", e.logical_id, e.parent)

        if e.collider is not None:
            comp_mask[i] |= COMP_COLLIDER
            st = _SHAPE_MAP.get(e.collider.shape, SHAPE_BOX)
            shape_type[i] = st
            # clamp tiny sizes as the reference's CreateShape does
            sz = np.asarray(e.collider.size, np.float32).copy()
            if st == SHAPE_BOX:
                sz = np.maximum(sz, 0.01)
            else:
                sz[0] = max(sz[0], 0.01)
                sz[1] = max(sz[1], 0.0)
                sz[2] = 0.0
            shape_size[i] = sz

        if e.rigid_body is not None:
            comp_mask[i] |= COMP_RIGID_BODY
            bt = _BODY_TYPE_MAP.get(e.rigid_body.type, BODY_STATIC)
            body_type[i] = bt
            friction[i] = e.rigid_body.friction
            restitution[i] = e.rigid_body.restitution
            layer[i] = e.rigid_body.layer or 1
            mask[i] = e.rigid_body.mask
            if bt == BODY_DYNAMIC:
                m = max(e.rigid_body.mass, 0.01)
                inv_mass[i] = 1.0 / m
                if shape_type[i] == SHAPE_BOX:
                    inv_inertia[i] = _box_inertia_inv(m, shape_size[i])
                elif shape_type[i] == SHAPE_CAPSULE:
                    inv_inertia[i] = _capsule_inertia_inv(
                        m, shape_size[i][0], shape_size[i][1]
                    )
        elif e.collider is not None:
            # a collider without a body is static collision-only
            body_type[i] = BODY_STATIC
            layer[i] = 1
            mask[i] = 0xFFFFFFFF

        if e.trigger is not None:
            comp_mask[i] |= COMP_TRIGGER
            triggers.append(i)

        if e.mesh_renderer is not None:
            comp_mask[i] |= COMP_MESH_RENDERER

        if e.character:
            characters.append(i)

    if auto_character_id and auto_character_id in logical_ids:
        ci = logical_ids[auto_character_id]
        if ci not in characters:
            characters.append(ci)
    for ci in characters:
        comp_mask[ci] |= COMP_CHARACTER

    t_slots = max_trigger_slots or max(1, len(triggers))
    trig_entity = np.full(t_slots, -1, np.int32)
    trig_shape = np.zeros(t_slots, np.int8)
    trig_size = np.zeros((t_slots, 3), np.float32)
    trig_layer = np.zeros(t_slots, np.uint32)
    trig_mask = np.zeros(t_slots, np.uint32)
    trig_one_shot = np.zeros(t_slots, bool)
    trig_active0 = np.ones(t_slots, bool)
    for s, ei in enumerate(triggers[:t_slots]):
        tr = ents[ei].trigger
        trig_entity[s] = ei
        trig_shape[s] = _SHAPE_MAP.get(tr.shape, SHAPE_BOX)
        trig_size[s] = tr.size
        trig_layer[s] = tr.layer
        trig_mask[s] = tr.mask
        trig_one_shot[s] = tr.one_shot
        trig_active0[s] = tr.active

    c_slots = max(1, len(characters))
    char_entity = np.full(c_slots, -1, np.int32)
    for s, ei in enumerate(characters):
        char_entity[s] = ei

    # characters collide on the character layer, as ghosts
    for ei in characters:
        layer[ei] = LAYER_CHARACTER
        mask[ei] = 0xFFFFFFFF
        shape_type[ei] = SHAPE_CAPSULE
        shape_size[ei] = (cfg.capsule_radius, cfg.capsule_height * 0.5, 0.0)
        body_type[ei] = BODY_KINEMATIC

    # the level table padded for runtime lifecycle: width to full capacity
    # and depth by `level_headroom`, so entity CRUD never changes a shape
    tight = compute_levels(parent, alive)
    level_nodes = np.full(
        (tight.shape[0] + max(level_headroom, 0), n), -1, np.int32
    )
    level_nodes[: tight.shape[0], : tight.shape[1]] = tight

    def t(a):
        return _tensor(a, device)

    def f32(v, shape=()):
        return torch.full(shape, v, dtype=torch.float32, device=device)

    static = StaticScene(
        parent=t(parent),
        level_nodes=t(level_nodes),
        body_type=t(body_type),
        shape_type=t(shape_type),
        shape_size=t(shape_size),
        inv_mass=t(inv_mass),
        inv_inertia_body=t(inv_inertia),
        friction=t(friction),
        restitution=t(restitution),
        layer=t(layer),
        mask=t(mask),
        trig_entity=t(trig_entity),
        trig_shape=t(trig_shape),
        trig_size=t(trig_size),
        trig_layer=t(trig_layer),
        trig_mask=t(trig_mask),
        trig_one_shot=t(trig_one_shot),
        char_entity=t(char_entity),
        char_radius=f32(cfg.capsule_radius, (c_slots,)),
        char_half_height=f32(cfg.capsule_height * 0.5, (c_slots,)),
        char_walk_speed=f32(cfg.walk_speed, (c_slots,)),
        char_jump_impulse=f32(cfg.jump_impulse, (c_slots,)),
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
        comp_mask=t(comp_mask),
        pos=t(pos),
        quat=math3d.quat_from_euler_xyz(t(euler)),
        scale=t(scale),
        trigger_active=t(trig_active0),
    )
    world = update_world_matrices(
        state.pos, state.quat, state.scale, static.parent,
        static.level_nodes, state.alive,
    )
    state = tree_replace(state, world=world)

    arrays = _build_render_arrays(desc, resources, logical_ids, n)
    render = RenderScene(**{k: t(v) for k, v in arrays.items()})

    counts = {
        "entities": n_real,
        "transforms": n_real,
        "mesh_renderers": int(sum(1 for e in ents if e.mesh_renderer)),
        "colliders": int(sum(1 for e in ents if e.collider)),
        "rigid_bodies": int(sum(1 for e in ents if e.rigid_body)),
        "triggers": len(triggers),
        "characters": len(characters),
    }
    log.info(
        "[SceneLoader] scene built: %d entities, %d mesh renderers, "
        "%d colliders, %d triggers, %d characters",
        counts["entities"], counts["mesh_renderers"], counts["colliders"],
        counts["triggers"], counts["characters"],
    )
    return BuiltScene(
        static=static,
        initial_state=state,
        render=render,
        logical_ids=logical_ids,
        entity_names=names,
        config=cfg,
        counts=counts,
    )


def _build_render_arrays(
    desc: SceneDesc,
    resources: ResourceManager,
    logical_ids: dict[str, int],
    capacity: int,
) -> dict[str, np.ndarray]:
    """Expand every (entity, submesh) into a per-instance triangle soup
    with baked material ids, the renderer's per-submesh resolution order
    (override -> entity material -> mesh MTL material -> default), then
    pack it with :func:`pack_render_scene`."""
    mat_list: list[MaterialDesc] = []
    mat_index: dict[str, int] = {}
    tex_list: list[np.ndarray] = []
    tex_index: dict[str, int] = {}

    def add_texture(name_or_none: str | None) -> int:
        if name_or_none is None:
            key = "__white"
            arr = resources.get_white_texture()
        else:
            key = name_or_none
            path = desc.textures.get(name_or_none)
            if path is None:
                # a direct path (an MTL map_Kd's absolute path)
                arr = (
                    resources.load_texture(name_or_none)
                    if name_or_none
                    else resources.get_checker_texture()
                )
            else:
                arr = resources.load_texture(path)
        if key in tex_index:
            return tex_index[key]
        tex_index[key] = len(tex_list)
        tex_list.append(arr)
        return tex_index[key]

    def add_material(m: MaterialDesc, tex_key: str | None) -> int:
        key = m.name
        if key in mat_index:
            return mat_index[key]
        mat_index[key] = len(mat_list)
        mat_list.append(m)
        add_texture(tex_key)
        return mat_index[key]

    # the default material first (id 0): white
    add_material(resources.get_default_material(), None)
    for name, m in desc.materials.items():
        resources.load_material(m)
        add_material(m, m.albedo_tex)

    meshes: dict[str, MeshData] = {}
    for name, md in desc.meshes.items():
        mesh = resources.load_mesh(md.obj, md.mtl)
        if mesh is not None:
            meshes[name] = mesh

    # per-MTL materials become entries too (the mesh-material fallback)
    mtl_mat_ids: dict[tuple[str, int], int] = {}
    for mesh_name, mesh in meshes.items():
        for mi, mm in enumerate(mesh.materials):
            mat = MaterialDesc(name=f"__mtl_{mesh_name}_{mi}_{mm.name}")
            mat.base_tint = np.asarray([*mm.kd, 1.0], np.float32)
            mtl_mat_ids[(mesh_name, mi)] = add_material(mat, mm.map_kd or None)

    vp, vn, vuv, vent, trimat = [], [], [], [], []
    for e in desc.entities:
        mr = e.mesh_renderer
        if mr is None:
            continue
        mesh = meshes.get(mr.mesh)
        if mesh is None:
            log.warning("entity '%s' references missing mesh '%s'", e.logical_id, mr.mesh)
            continue
        ei = logical_ids[e.logical_id]
        ent_mat_id = mat_index.get(mr.material) if mr.material else None
        for si, sm in enumerate(mesh.submeshes):
            if si in mr.material_overrides and mr.material_overrides[si] in mat_index:
                mid = mat_index[mr.material_overrides[si]]
            elif ent_mat_id is not None:
                mid = ent_mat_id
            elif (mr.mesh, sm.material_index) in mtl_mat_ids:
                mid = mtl_mat_ids[(mr.mesh, sm.material_index)]
            else:
                mid = 0
            sl = slice(sm.start_index, sm.start_index + sm.index_count)
            vp.append(mesh.positions[sl])
            vn.append(mesh.normals[sl])
            vuv.append(mesh.uvs[sl])
            vent.append(np.full(sm.index_count, ei, np.int32))
            trimat.append(np.full(sm.index_count // 3, mid, np.int32))

    m_count = len(mat_list)
    mat_tex = np.zeros(m_count, np.int32)
    for name, idx in mat_index.items():
        m = mat_list[idx]
        if m.albedo_tex and m.albedo_tex in tex_index:
            mat_tex[idx] = tex_index[m.albedo_tex]
    # MTL materials registered their texture under the map_Kd path
    for (mesh_name, mi), mid in mtl_mat_ids.items():
        mm = meshes[mesh_name].materials[mi]
        if mm.map_kd and mm.map_kd in tex_index:
            mat_tex[mid] = tex_index[mm.map_kd]
        else:
            mat_tex[mid] = tex_index["__white"]
    for name, m in desc.materials.items():
        if m.albedo_tex is None and name in mat_index:
            mat_tex[mat_index[name]] = tex_index["__white"]

    def cat(parts, width, dtype):
        return (np.concatenate(parts) if parts
                else np.zeros((0, width) if width else 0, dtype))

    return pack_render_scene(
        cat(vp, 3, np.float32), cat(vn, 3, np.float32),
        cat(vuv, 2, np.float32), cat(vent, 0, np.int32),
        cat(trimat, 0, np.int32), tex_list,
        np.stack([m.base_tint for m in mat_list]),
        np.stack([m.uv_scale for m in mat_list]),
        np.stack([np.asarray([m.shininess, m.spec_intensity], np.float32)
                  for m in mat_list]),
        np.stack([m.spec_color for m in mat_list]),
        mat_tex, capacity)
