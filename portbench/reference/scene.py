"""The box world's render arrays, worked out by the reference itself.

Frozen copy of the port's ``scene/synthetic.py`` :func:`build_box_render`
(with its cube template) and ``scene/build.py`` :func:`pack_render_scene`
(with its texture pages), less the deduplicated edges, which only the
wireframe frame reads.  Input: each body's shape type and half extents;
output: the render arrays as tensors on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.state import SHAPE_BOX

_CUBE_CORNERS = np.array(
    [[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
     [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float32)
_CUBE_FACES = (
    ([0, 3, 2, 1], [0, 0, -1]), ([4, 5, 6, 7], [0, 0, 1]),
    ([0, 1, 5, 4], [0, -1, 0]), ([3, 7, 6, 2], [0, 1, 0]),
    ([0, 4, 7, 3], [-1, 0, 0]), ([1, 2, 6, 5], [1, 0, 0]),
)
_QUAD_UV = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
TINTS = [(1.0, 1.0, 1.0, 1.0), (0.9, 0.35, 0.25, 1.0),
         (0.3, 0.55, 0.9, 1.0), (0.95, 0.85, 0.3, 1.0)]


def _cube_template():
    pos, nrm, uv = [], [], []
    for idx, n in _CUBE_FACES:
        for tri in ((0, 1, 2), (0, 2, 3)):
            for c in tri:
                pos.append(_CUBE_CORNERS[idx[c]])
                nrm.append(n)
                uv.append(_QUAD_UV[c])
    return (np.asarray(pos, np.float32), np.asarray(nrm, np.float32),
            np.asarray(uv, np.float32))


def _texture_pages(tex_list):
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


def box_render(shape_type, half, device) -> dict:
    """The render arrays of a box world: every box body gets the 12
    triangles of its box, ``v_entity`` its index, one of four tinted
    white materials; triangles padded to a multiple of 128."""
    shape = np.asarray(shape_type)
    half = np.asarray(half, np.float32)
    capacity = len(shape)
    bodies = np.nonzero(shape == SHAPE_BOX)[0].astype(np.int32)
    cube_pos, cube_nrm, cube_uv = _cube_template()
    v_pos = (cube_pos[None] * half[bodies][:, None, :]).reshape(-1, 3)
    v_nrm = np.tile(cube_nrm, (len(bodies), 1))
    v_uv = np.tile(cube_uv, (len(bodies), 1))
    v_entity = np.repeat(bodies, len(cube_pos))
    tri_material = np.repeat(1 + bodies % 4, len(cube_pos) // 3)

    ent_has_mesh = np.zeros(capacity, bool)
    ent_aabb_min = np.zeros((capacity, 3), np.float32)
    ent_aabb_max = np.zeros((capacity, 3), np.float32)
    ents = np.unique(v_entity)
    ent_has_mesh[ents] = True
    lo = np.full((capacity, 3), np.inf, np.float32)
    hi = np.full((capacity, 3), -np.inf, np.float32)
    np.minimum.at(lo, v_entity, v_pos)
    np.maximum.at(hi, v_entity, v_pos)
    ent_aabb_min[ents] = lo[ents]
    ent_aabb_max[ents] = hi[ents]

    n_tri = len(tri_material)
    pad_tri = (-n_tri) % 128
    tri_valid = np.concatenate([np.ones(n_tri, bool), np.zeros(pad_tri, bool)])
    v_pos = np.concatenate([v_pos, np.zeros((pad_tri * 3, 3), np.float32)])
    v_nrm = np.concatenate([v_nrm, np.tile(np.array([[0, 1, 0]], np.float32),
                                           (pad_tri * 3, 1))])
    v_uv = np.concatenate([v_uv, np.zeros((pad_tri * 3, 2), np.float32)])
    v_entity = np.concatenate([v_entity, np.zeros(pad_tri * 3, np.int32)])
    tri_material = np.concatenate([tri_material, np.zeros(pad_tri, np.int32)])

    white = np.full((1, 1, 4), 255, np.uint8)
    tex_arr, tex_size, tex_quad = _texture_pages([white])
    arrays = dict(
        v_pos=v_pos, v_nrm=v_nrm, v_uv=v_uv, v_entity=v_entity,
        tri_material=tri_material, tri_valid=tri_valid,
        mat_base_tint=np.asarray([TINTS[0]] + TINTS, np.float32),
        mat_uv_scale=np.ones((5, 2), np.float32),
        mat_spec_params=np.tile(np.float32([32.0, 0.35]), (5, 1)),
        mat_spec_color=np.ones((5, 3), np.float32),
        mat_tex=np.zeros(5, np.int32),
        textures=tex_arr, tex_size=tex_size, textures_quad=tex_quad,
        textures_quad_t=np.ascontiguousarray(tex_quad.reshape(-1, 16).T),
        ent_aabb_min=ent_aabb_min, ent_aabb_max=ent_aabb_max,
        ent_has_mesh=ent_has_mesh)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}
