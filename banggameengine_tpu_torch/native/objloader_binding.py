"""ctypes binding for the native OBJ loader.

Counterpart of ``banggameengine_tpu/native/objloader_binding.py``: the
same structures and the same :class:`MeshData` as the Python loader
(:mod:`banggameengine_tpu_torch.scene.obj_loader`)."""

from __future__ import annotations

import ctypes as ct

import numpy as np

from banggameengine_tpu_torch.native.build import build_native
from banggameengine_tpu_torch.scene.obj_loader import MeshData, MtlMaterial, Submesh

_lib = None


class _BangSubmesh(ct.Structure):
    _fields_ = [
        ("start_index", ct.c_int32),
        ("index_count", ct.c_int32),
        ("material_index", ct.c_int32),
    ]


class _BangMaterial(ct.Structure):
    _fields_ = [
        ("kd", ct.c_float * 3),
        ("name", ct.c_char * 256),
        ("map_kd", ct.c_char * 1024),
    ]


class _BangMesh(ct.Structure):
    _fields_ = [
        ("num_vertices", ct.c_int32),
        ("positions", ct.POINTER(ct.c_float)),
        ("normals", ct.POINTER(ct.c_float)),
        ("uvs", ct.POINTER(ct.c_float)),
        ("num_submeshes", ct.c_int32),
        ("submeshes", ct.POINTER(_BangSubmesh)),
        ("num_materials", ct.c_int32),
        ("materials", ct.POINTER(_BangMaterial)),
    ]


def _get_lib():
    global _lib
    if _lib is not None:
        return _lib
    path = build_native()
    if path is None:
        return None
    lib = ct.CDLL(path)
    lib.bang_load_obj.restype = ct.POINTER(_BangMesh)
    lib.bang_load_obj.argtypes = [ct.c_char_p, ct.c_char_p, ct.c_int]
    lib.bang_free_mesh.argtypes = [ct.POINTER(_BangMesh)]
    _lib = lib
    return lib


def load_obj_native(
    obj_path: str, mtl_path: str | None = None, flip_v: bool = True
) -> MeshData | None:
    """Load an OBJ through the C++ loader.  None when unavailable/failed
    (callers fall back to the Python loader)."""
    lib = _get_lib()
    if lib is None:
        return None
    mp = mtl_path.encode() if mtl_path else None
    ptr = lib.bang_load_obj(obj_path.encode(), mp, 1 if flip_v else 0)
    if not ptr:
        return None
    try:
        m = ptr.contents
        v = m.num_vertices
        pos = np.ctypeslib.as_array(m.positions, (v, 3)).copy()
        nrm = np.ctypeslib.as_array(m.normals, (v, 3)).copy()
        uv = np.ctypeslib.as_array(m.uvs, (v, 2)).copy()
        subs = [
            Submesh(
                start_index=int(m.submeshes[i].start_index),
                index_count=int(m.submeshes[i].index_count),
                material_index=int(m.submeshes[i].material_index),
            )
            for i in range(m.num_submeshes)
        ]
        mats = []
        for i in range(m.num_materials):
            mm = m.materials[i]
            # kept as the library gives it; resolution happens downstream
            map_kd = mm.map_kd.decode(errors="replace") or None
            mats.append(
                MtlMaterial(
                    name=mm.name.decode(errors="replace"),
                    kd=tuple(float(x) for x in mm.kd),
                    map_kd=map_kd,
                )
            )
        return MeshData(
            positions=pos.astype(np.float32),
            normals=nrm.astype(np.float32),
            uvs=uv.astype(np.float32),
            colors=np.ones((v, 4), np.float32),
            indices=np.arange(v, dtype=np.int32),
            submeshes=subs,
            materials=mats,
        )
    finally:
        lib.bang_free_mesh(ptr)
