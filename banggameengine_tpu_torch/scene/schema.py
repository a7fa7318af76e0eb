"""Scene JSON schema parsing (host side).

A copy of ``banggameengine_tpu/scene/schema.py`` (numpy and json only;
the JAX package cannot be imported without JAX), its logic unchanged.

Parses the reference's scene format (``assets/scenes/demo.json``) with the
same tolerant semantics as ``src/scene/SceneLoader.cpp``:

- scalars accept number-or-string (``SceneLoader.cpp:114-189``);
- ``rotationEuler`` (radians) or ``rotationEulerDeg`` (``:435-504``);
- collider/trigger: box ``size`` = **half extents**, capsule ``radius`` +
  ``height`` (full) -> (radius, half_height) (``:208-232``, confirmed against
  ``PhysicsSystem::CreateShape`` which passes size straight to
  ``btBoxShape``/``btCapsuleShape`` — entity scale is NOT applied);
- rigidBody ``type`` case-insensitive Static/Dynamic/Kinematic, mass forced 0
  unless Dynamic (``:234-271``); dynamic mass floor 0.01 applied later;
- trigger default layer = 1<<2 when 0/absent (``:289``);
- entities may nest ``children`` and/or use string ``parent`` refs resolved
  after all entities load (``:629-648``); anonymous entities get an
  auto ``__entity_N`` logical key (``:597-601``); duplicate ids warn and
  overwrite (``:99-112``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
from typing import Any

import numpy as np

log = logging.getLogger("SceneLoader")

DEFAULT_TRIGGER_LAYER = 1 << 2
DEFAULT_WORLD_LAYER = 1 << 0


def _as_float(v: Any, default: float = 0.0) -> float:
    """Number-or-string scalar (SceneLoader.cpp:114-148)."""
    if isinstance(v, bool):
        return float(v)
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        try:
            return float(v)
        except ValueError:
            return default
    return default


def _as_uint(v: Any, default: int = 0) -> int:
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, (int, float)):
        return int(v) & 0xFFFFFFFF
    if isinstance(v, str):
        try:
            return int(float(v)) & 0xFFFFFFFF
        except ValueError:
            return default
    return default


def _read_vec3(v: Any, default: tuple[float, float, float]) -> np.ndarray:
    out = np.asarray(default, np.float32).copy()
    if isinstance(v, (list, tuple)):
        for i in range(min(3, len(v))):
            out[i] = _as_float(v[i], out[i])
    return out


def _read_vec4(v: Any, default: tuple[float, ...]) -> np.ndarray:
    out = np.asarray(default, np.float32).copy()
    if isinstance(v, (list, tuple)):
        for i in range(min(4, len(v))):
            out[i] = _as_float(v[i], out[i])
    return out


@dataclasses.dataclass
class MaterialDesc:
    name: str
    base_tint: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(4, np.float32)
    )
    uv_scale: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(2, np.float32)
    )
    albedo_tex: str | None = None  # texture resource name
    # global defaults forced by the renderer (Renderer.cpp:657-659)
    shininess: float = 32.0
    spec_intensity: float = 0.35
    spec_color: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32)
    )


@dataclasses.dataclass
class MeshDesc:
    name: str
    obj: str
    mtl: str | None = None


@dataclasses.dataclass
class TransformDesc:
    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    rotation_euler: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )  # radians
    scale: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32)
    )


@dataclasses.dataclass
class MeshRendererDesc:
    mesh: str
    material: str | None = None
    material_overrides: dict[int, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ColliderDesc:
    shape: str = "box"  # 'box' | 'capsule'
    size: np.ndarray = dataclasses.field(
        default_factory=lambda: np.asarray([0.5, 0.5, 0.5], np.float32)
    )  # box: half extents; capsule: (radius, half_height, 0)


@dataclasses.dataclass
class RigidBodyDesc:
    type: str = "static"  # 'static' | 'dynamic' | 'kinematic'
    mass: float = 0.0
    friction: float = 0.5
    restitution: float = 0.0
    layer: int = DEFAULT_WORLD_LAYER
    mask: int = 0xFFFFFFFF


@dataclasses.dataclass
class TriggerDesc:
    shape: str = "box"
    size: np.ndarray = dataclasses.field(
        default_factory=lambda: np.asarray([0.5, 0.5, 0.5], np.float32)
    )
    layer: int = DEFAULT_TRIGGER_LAYER
    mask: int = 0xFFFFFFFF
    one_shot: bool = False
    active: bool = True


@dataclasses.dataclass
class EntityDesc:
    logical_id: str
    name: str
    transform: TransformDesc = dataclasses.field(default_factory=TransformDesc)
    mesh_renderer: MeshRendererDesc | None = None
    collider: ColliderDesc | None = None
    rigid_body: RigidBodyDesc | None = None
    trigger: TriggerDesc | None = None
    character: bool = False  # PhysicsCharacter marker
    parent: str | None = None  # logical id of parent, resolved at build


@dataclasses.dataclass
class SceneDesc:
    textures: dict[str, str] = dataclasses.field(default_factory=dict)
    materials: dict[str, MaterialDesc] = dataclasses.field(default_factory=dict)
    meshes: dict[str, MeshDesc] = dataclasses.field(default_factory=dict)
    entities: list[EntityDesc] = dataclasses.field(default_factory=list)

    def find(self, logical_id: str) -> EntityDesc | None:
        for e in self.entities:
            if e.logical_id == logical_id:
                return e
        return None


def _parse_collider_common(j: dict, default_size) -> tuple[str, np.ndarray]:
    shape = str(j.get("shape", "box")).lower()
    if shape not in ("box", "capsule"):
        log.warning("unknown collider shape '%s', using 'box'", shape)
        shape = "box"
    size = np.asarray(default_size, np.float32).copy()
    if shape == "box":
        size = _read_vec3(j.get("size"), tuple(size))
    else:
        radius = _as_float(j.get("radius"), size[0])
        height = _as_float(j.get("height"), size[1] * 2.0)
        size = np.asarray([radius, height * 0.5, 0.0], np.float32)
    return shape, size


def _parse_transform(j: dict) -> TransformDesc:
    t = TransformDesc()
    t.position = _read_vec3(j.get("position"), (0, 0, 0))
    if "rotationEulerDeg" in j:
        deg = _read_vec3(j.get("rotationEulerDeg"), (0, 0, 0))
        t.rotation_euler = np.deg2rad(deg).astype(np.float32)
    else:
        t.rotation_euler = _read_vec3(j.get("rotationEuler"), (0, 0, 0))
    t.scale = _read_vec3(j.get("scale"), (1, 1, 1))
    return t


def _parse_entity(
    j: dict, out: list[EntityDesc], parent: str | None, counter: list[int]
) -> None:
    logical = j.get("id") or j.get("name")
    if not logical:
        logical = f"__entity_{counter[0]}"
    counter[0] += 1
    name = j.get("name", logical)

    ent = EntityDesc(logical_id=str(logical), name=str(name), parent=parent)
    if "transform" in j and isinstance(j["transform"], dict):
        ent.transform = _parse_transform(j["transform"])

    mr = j.get("meshRenderer")
    if isinstance(mr, dict) and mr.get("mesh"):
        overrides: dict[int, str] = {}
        for k, v in (mr.get("materialOverrides") or {}).items():
            try:
                overrides[int(k)] = str(v)
            except (ValueError, TypeError):
                log.warning("bad materialOverrides key %r", k)
        ent.mesh_renderer = MeshRendererDesc(
            mesh=str(mr["mesh"]),
            material=mr.get("material"),
            material_overrides=overrides,
        )

    col = j.get("collider")
    if isinstance(col, dict):
        shape, size = _parse_collider_common(col, (0.5, 0.5, 0.5))
        ent.collider = ColliderDesc(shape=shape, size=size)

    rb = j.get("rigidBody")
    if isinstance(rb, dict):
        body = RigidBodyDesc()
        body.type = str(rb.get("type", "Static")).lower()
        if body.type not in ("static", "dynamic", "kinematic"):
            body.type = "static"
        body.mass = _as_float(rb.get("mass"), 1.0) if body.type == "dynamic" else 0.0
        body.friction = _as_float(rb.get("friction"), body.friction)
        body.restitution = _as_float(rb.get("restitution"), body.restitution)
        body.layer = _as_uint(rb.get("layer"), body.layer) or DEFAULT_WORLD_LAYER
        body.mask = _as_uint(rb.get("mask"), body.mask)
        ent.rigid_body = body
        if ent.collider is None:
            log.warning("rigidBody on '%s' without collider", ent.logical_id)

    trig = j.get("trigger")
    if isinstance(trig, dict):
        shape, size = _parse_collider_common(trig, (0.5, 0.5, 0.5))
        t = TriggerDesc(shape=shape, size=size)
        t.layer = _as_uint(trig.get("layer"), 0) or DEFAULT_TRIGGER_LAYER
        t.mask = _as_uint(trig.get("mask"), t.mask)
        t.one_shot = bool(trig.get("oneShot", t.one_shot))
        t.active = bool(trig.get("active", True))
        ent.trigger = t

    if j.get("character"):
        ent.character = True

    # duplicate logical ids: warn & overwrite (SceneLoader.cpp:99-112)
    for i, prev in enumerate(out):
        if prev.logical_id == ent.logical_id:
            log.warning("duplicate entity id '%s' overwritten", ent.logical_id)
            out[i] = ent
            break
    else:
        out.append(ent)

    # explicit string parent ref wins over nesting
    if isinstance(j.get("parent"), str):
        ent.parent = j["parent"]

    for child in j.get("children", []) or []:
        if isinstance(child, dict):
            _parse_entity(child, out, ent.logical_id, counter)


def parse_scene_json(path: str) -> SceneDesc:
    """Parse a scene file into a SceneDesc. Raises on JSON errors so callers
    can keep the previous scene (SceneLoader.cpp:688-742 atomic-swap)."""
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)

    desc = SceneDesc()
    res = data.get("resources", {}) or {}
    for name, p in (res.get("textures") or {}).items():
        if isinstance(p, str):
            desc.textures[str(name)] = p

    for name, m in (res.get("materials") or {}).items():
        if not isinstance(m, dict):
            continue
        mat = MaterialDesc(name=str(name))
        mat.base_tint = _read_vec4(m.get("baseTint"), (1, 1, 1, 1))
        uv = m.get("uv", m.get("uvScale"))
        uv2 = _read_vec3(uv, (1, 1, 0))[:2] if uv is not None else np.ones(2, np.float32)
        mat.uv_scale = uv2.astype(np.float32)
        tex = m.get("albedoTex")
        mat.albedo_tex = str(tex) if isinstance(tex, str) else None
        desc.materials[mat.name] = mat

    for name, m in (res.get("meshes") or {}).items():
        if isinstance(m, str):
            desc.meshes[str(name)] = MeshDesc(name=str(name), obj=m)
        elif isinstance(m, dict) and m.get("obj"):
            desc.meshes[str(name)] = MeshDesc(
                name=str(name), obj=str(m["obj"]), mtl=m.get("mtl")
            )

    counter = [0]
    for ent in data.get("entities", []) or []:
        if isinstance(ent, dict):
            _parse_entity(ent, desc.entities, None, counter)

    return desc
