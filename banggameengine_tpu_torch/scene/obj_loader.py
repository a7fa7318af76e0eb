"""Wavefront OBJ + MTL loader producing NumPy SoA mesh data.

A copy of ``banggameengine_tpu/scene/obj_loader.py`` (numpy only; the JAX
package cannot be imported without JAX), its logic unchanged.

Host-side replacement for the reference's tinyobjloader wrapper
(``src/asset/ObjLoader.cpp:52-272``).  Preserves its observable semantics:

- triangulates polygons (fan), emits **unshared** vertices — one vertex per
  face corner, no dedup (``ObjLoader.cpp:144-177``) — which vectorizes
  perfectly on TPU;
- computes the face normal when a corner has no normal index
  (``ObjLoader.cpp:34-44``);
- optional V flip, default **on** (``ObjLoader.h:23``);
- partitions triangles into contiguous per-material submesh ranges in
  first-seen material order (``ObjLoader.cpp:97-117, 194-244``);
- reads only ``Kd`` and ``map_Kd`` from MTL (matching the standalone parser at
  ``ResourceManager.cpp:240-259``), searching textures next to the OBJ.

Unlike the reference we use int32 indices (no 65,536-vertex cap,
``ObjLoader.cpp:170``); vertex color is constant white (``ObjLoader.cpp:167``).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class MtlMaterial:
    name: str
    kd: tuple[float, float, float] = (1.0, 1.0, 1.0)
    map_kd: str | None = None  # absolute path if found


@dataclasses.dataclass
class Submesh:
    start_index: int
    index_count: int
    material_index: int  # into MeshData.materials; -1 = none


@dataclasses.dataclass
class MeshData:
    """Unshared-corner triangle soup, ready for device upload."""

    positions: np.ndarray  # f32[V,3]
    normals: np.ndarray    # f32[V,3]
    uvs: np.ndarray        # f32[V,2]
    colors: np.ndarray     # f32[V,4] (constant white)
    indices: np.ndarray    # i32[I] (== arange here, kept for parity)
    submeshes: list[Submesh]
    materials: list[MtlMaterial]

    @property
    def num_vertices(self) -> int:
        return len(self.positions)

    @property
    def num_triangles(self) -> int:
        return len(self.indices) // 3

    def approx_bytes(self) -> int:
        # parity with MeshLoader.cpp:38-41: verts*stride + indices*2
        stride = (3 + 3 + 1 + 2) * 4  # pos+normal+color0(u8x4)+uv as in ref layout
        return self.num_vertices * stride + len(self.indices) * 2


def parse_mtl(path: str) -> dict[str, MtlMaterial]:
    """Parse an MTL file; texture paths resolved relative to the MTL's dir."""
    mats: dict[str, MtlMaterial] = {}
    cur: MtlMaterial | None = None
    base = os.path.dirname(os.path.abspath(path))
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "newmtl" and len(parts) > 1:
                cur = MtlMaterial(name=parts[1])
                mats[cur.name] = cur
            elif cur is not None and tag == "Kd" and len(parts) >= 4:
                cur.kd = (float(parts[1]), float(parts[2]), float(parts[3]))
            elif cur is not None and tag == "map_Kd" and len(parts) > 1:
                tex = " ".join(parts[1:])
                cand = tex if os.path.isabs(tex) else os.path.join(base, tex)
                cur.map_kd = cand
    return mats


def load_obj(
    obj_path: str,
    mtl_path: str | None = None,
    flip_v: bool = True,
) -> MeshData:
    """Load an OBJ file into unshared-corner SoA arrays.

    ``mtl_path`` overrides the file's ``mtllib`` (the reference lets the scene
    specify an explicit ``mtl``, ``SceneLoader.cpp:398-433``).
    """
    positions_in: list[list[float]] = []
    uvs_in: list[list[float]] = []
    normals_in: list[list[float]] = []
    # faces: list of (corner list [(vi, ti, ni)], material_index)
    faces: list[tuple[list[tuple[int, int, int]], int]] = []
    mtllibs: list[str] = []
    material_names: list[str] = []  # first-seen order
    name_to_idx: dict[str, int] = {}
    cur_mat = -1
    obj_dir = os.path.dirname(os.path.abspath(obj_path))

    def parse_index(tok: str) -> tuple[int, int, int]:
        comp = tok.split("/")
        vi = int(comp[0]) if comp[0] else 0
        ti = int(comp[1]) if len(comp) > 1 and comp[1] else 0
        ni = int(comp[2]) if len(comp) > 2 and comp[2] else 0
        return vi, ti, ni

    with open(obj_path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "v":
                positions_in.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                uvs_in.append([float(x) for x in parts[1:3]])
            elif tag == "vn":
                normals_in.append([float(x) for x in parts[1:4]])
            elif tag == "usemtl":
                name = parts[1] if len(parts) > 1 else ""
                if name not in name_to_idx:
                    name_to_idx[name] = len(material_names)
                    material_names.append(name)
                cur_mat = name_to_idx[name]
            elif tag == "mtllib" and len(parts) > 1:
                mtllibs.append(" ".join(parts[1:]))
            elif tag == "f":
                corners = [parse_index(t) for t in parts[1:]]
                # triangulate as a fan (tinyobjloader triangulate=true)
                for k in range(1, len(corners) - 1):
                    faces.append(([corners[0], corners[k], corners[k + 1]], cur_mat))

    # resolve materials
    mtl_file = mtl_path
    if mtl_file is None and mtllibs:
        cand = os.path.join(obj_dir, mtllibs[0])
        if os.path.exists(cand):
            mtl_file = cand
    mtl_map: dict[str, MtlMaterial] = {}
    if mtl_file and os.path.exists(mtl_file):
        mtl_map = parse_mtl(mtl_file)
    materials = [
        mtl_map.get(n, MtlMaterial(name=n)) for n in material_names
    ]

    pos_arr = np.asarray(positions_in, np.float32).reshape(-1, 3)
    uv_arr = (
        np.asarray(uvs_in, np.float32).reshape(-1, 2)
        if uvs_in
        else np.zeros((0, 2), np.float32)
    )
    nrm_arr = (
        np.asarray(normals_in, np.float32).reshape(-1, 3)
        if normals_in
        else np.zeros((0, 3), np.float32)
    )

    # Partition faces per material, preserving first-seen order; faces with no
    # material (-1) go last (reference keeps them under material -1 too).
    order = list(range(len(material_names))) + ([-1] if any(m == -1 for _, m in faces) else [])
    out_pos, out_uv, out_nrm = [], [], []
    submeshes: list[Submesh] = []
    index_cursor = 0

    def resolve(idx: int, count: int) -> int:
        """OBJ 1-based (negative = relative) -> 0-based."""
        if idx > 0:
            return idx - 1
        if idx < 0:
            return count + idx
        return -1

    for mat in order:
        start = index_cursor
        for corners, fm in faces:
            if fm != mat:
                continue
            vi = [resolve(c[0], len(pos_arr)) for c in corners]
            ti = [resolve(c[1], len(uv_arr)) for c in corners]
            ni = [resolve(c[2], len(nrm_arr)) for c in corners]
            p = pos_arr[vi]  # [3,3]
            # face normal fallback (ObjLoader.cpp:34-44)
            fn = np.cross(p[1] - p[0], p[2] - p[0])
            ln = np.linalg.norm(fn)
            fn = fn / ln if ln > 1e-12 else np.array([0, 1, 0], np.float32)
            for c in range(3):
                out_pos.append(p[c])
                out_nrm.append(nrm_arr[ni[c]] if ni[c] >= 0 else fn)
                if ti[c] >= 0:
                    u, v = uv_arr[ti[c]]
                    out_uv.append([u, 1.0 - v if flip_v else v])
                else:
                    out_uv.append([0.0, 0.0])
            index_cursor += 3
        count = index_cursor - start
        if count > 0:
            submeshes.append(Submesh(start, count, mat))

    n = index_cursor
    return MeshData(
        positions=np.asarray(out_pos, np.float32).reshape(n, 3),
        normals=np.asarray(out_nrm, np.float32).reshape(n, 3),
        uvs=np.asarray(out_uv, np.float32).reshape(n, 2),
        colors=np.ones((n, 4), np.float32),
        indices=np.arange(n, dtype=np.int32),
        submeshes=submeshes,
        materials=materials,
    )


def make_cube(half: float = 0.5) -> MeshData:
    """Built-in unit cube (parity with Renderer.cpp:833-863)."""
    h = half
    corners = np.array(
        [
            [-h, -h, -h], [h, -h, -h], [h, h, -h], [-h, h, -h],
            [-h, -h, h], [h, -h, h], [h, h, h], [-h, h, h],
        ],
        np.float32,
    )
    # 6 faces, two triangles each, outward normals
    quads = [
        ([0, 3, 2, 1], [0, 0, -1]),
        ([4, 5, 6, 7], [0, 0, 1]),
        ([0, 1, 5, 4], [0, -1, 0]),
        ([3, 7, 6, 2], [0, 1, 0]),
        ([0, 4, 7, 3], [-1, 0, 0]),
        ([1, 2, 6, 5], [1, 0, 0]),
    ]
    pos, nrm, uv = [], [], []
    for idx, n in quads:
        quad = corners[idx]
        for tri in ([0, 1, 2], [0, 2, 3]):
            for c in tri:
                pos.append(quad[c])
                nrm.append(n)
                uv.append([0.0, 0.0])
    n_v = len(pos)
    return MeshData(
        positions=np.asarray(pos, np.float32),
        normals=np.asarray(nrm, np.float32),
        uvs=np.asarray(uv, np.float32),
        colors=np.ones((n_v, 4), np.float32),
        indices=np.arange(n_v, dtype=np.int32),
        submeshes=[Submesh(0, n_v, -1)],
        materials=[],
    )


def make_ground_plane(half: float = 250.0, uv_tiles: float = 50.0) -> MeshData:
    """Built-in 500x500 ground plane with 50x UV tiling
    (parity with Renderer.cpp:865-882)."""
    h = half
    quad = np.array(
        [[-h, 0, -h], [h, 0, -h], [h, 0, h], [-h, 0, h]], np.float32
    )
    uvq = np.array(
        [[0, 0], [uv_tiles, 0], [uv_tiles, uv_tiles], [0, uv_tiles]], np.float32
    )
    pos, uv = [], []
    for tri in ([0, 2, 1], [0, 3, 2]):
        for c in tri:
            pos.append(quad[c])
            uv.append(uvq[c])
    n_v = len(pos)
    return MeshData(
        positions=np.asarray(pos, np.float32),
        normals=np.tile(np.array([[0, 1, 0]], np.float32), (n_v, 1)),
        uvs=np.asarray(uv, np.float32),
        colors=np.ones((n_v, 4), np.float32),
        indices=np.arange(n_v, dtype=np.int32),
        submeshes=[Submesh(0, n_v, -1)],
        materials=[],
    )
