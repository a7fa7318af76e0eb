"""Render scene container and its numpy packer.

Counterpart of ``banggameengine_tpu/scene/build.py``: :class:`RenderScene`
holds the same 21 fields as the JAX package's, as tensors, and
:func:`pack_render_scene` reproduces the tail of the JAX package's
``_build_render_scene`` (edge dedupe, padding the triangle count to a
multiple of 128, power-of-two square texture pages, the ``[T, S, S, 16]``
texel-quad pack and its channel-major ``[16, T*S*S]`` copy, entity AABBs)
from an already-expanded triangle soup.  The scene-file parser and the
asset loaders are not ported: the port's scenes are procedural
(:mod:`banggameengine_tpu_torch.scene.synthetic`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from banggameengine_tpu_torch.state import StaticScene, WorldState

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
    """What ``make_frame_fn`` needs of a loaded scene (the JAX package's
    ``BuiltScene`` without the host bookkeeping)."""

    static: StaticScene
    initial_state: WorldState
    render: RenderScene


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
