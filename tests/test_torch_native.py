"""The port's native OBJ loader against its Python loader and the JAX
package's native loader.

Counterpart of ``tests/test_native.py``, test for test.  The port builds
``banggameengine_tpu_torch/native/{objloader,xcbwindow}.cpp`` (copies of
the JAX package's sources) into ``banggameengine_tpu_torch/_build/``.
Bars are ``tests/test_native.py``'s: positions and uvs within 1e-6,
normals within 1e-5, material colours within 1e-6, submeshes and
material names exact; the port's native mesh equals the JAX package's
native mesh exactly (one C++ source).  The reference's own demo meshes
are not in the repository, so the parity runs on
``tests/data/app_assets`` and on OBJ files the tests write.
"""

import os
import textwrap

import numpy as np
import pytest

from banggameengine_tpu.native import load_obj_native as jax_load_obj_native
from banggameengine_tpu_torch.native import LIB_PATH, build_native
from banggameengine_tpu_torch.native import load_obj_native
from banggameengine_tpu_torch.scene.obj_loader import load_obj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APP_MESHES = os.path.join(REPO, "tests", "data", "app_assets", "meshes")

pytestmark = pytest.mark.skipif(
    build_native() is None, reason="native toolchain unavailable")


def assert_mesh_parity(native, python):
    assert native.num_vertices == python.num_vertices
    np.testing.assert_allclose(native.positions, python.positions, atol=1e-6)
    np.testing.assert_allclose(native.normals, python.normals, atol=1e-5)
    np.testing.assert_allclose(native.uvs, python.uvs, atol=1e-6)
    assert len(native.submeshes) == len(python.submeshes)
    for a, b in zip(native.submeshes, python.submeshes):
        assert (a.start_index, a.index_count, a.material_index) == (
            b.start_index, b.index_count, b.material_index)
    assert ([m.name for m in native.materials]
            == [m.name for m in python.materials])
    for a, b in zip(native.materials, python.materials):
        np.testing.assert_allclose(a.kd, b.kd, atol=1e-6)


def assert_same_mesh(a, b):
    """Two meshes of one C++ loader: every array and field equal."""
    for f in ("positions", "normals", "uvs", "colors", "indices"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert [(s.start_index, s.index_count, s.material_index)
            for s in a.submeshes] == [
        (s.start_index, s.index_count, s.material_index) for s in b.submeshes]
    assert [(m.name, m.kd, m.map_kd) for m in a.materials] == [
        (m.name, m.kd, m.map_kd) for m in b.materials]


def test_native_simple_parity(tmp_path):
    (tmp_path / "m.mtl").write_text(
        "newmtl red\nKd 0.9 0.1 0.2\nmap_Kd tex.png\n")
    obj = tmp_path / "t.obj"
    obj.write_text(textwrap.dedent(
        """
        mtllib m.mtl
        v 0 0 0
        v 1 0 0
        v 1 1 0
        v 0 1 0
        vt 0 0
        vt 1 0
        vt 1 1
        vt 0 1
        usemtl red
        f 1/1 2/2 3/3 4/4
        f 1 3 2
        """))
    nat = load_obj_native(str(obj))
    assert nat is not None
    assert_mesh_parity(nat, load_obj(str(obj)))
    assert_same_mesh(nat, jax_load_obj_native(str(obj)))
    # MTL texture path joined with directory
    assert nat.materials[0].map_kd.endswith("tex.png")


@pytest.mark.parametrize("name", ["character.obj", "ground.obj"])
def test_native_app_mesh_parity(name):
    p = os.path.join(APP_MESHES, name)
    nat = load_obj_native(p)
    assert nat is not None and nat.num_triangles > 0
    assert_mesh_parity(nat, load_obj(p))
    assert_same_mesh(nat, jax_load_obj_native(p))


def test_native_is_used_by_resource_manager(monkeypatch):
    import banggameengine_tpu_torch.native as native_mod
    from banggameengine_tpu_torch.scene.resources import ResourceManager

    monkeypatch.delenv("BANG_DISABLE_NATIVE", raising=False)
    monkeypatch.delenv("BANG_ASSETS_DIR", raising=False)
    called = {}
    orig = native_mod.load_obj_native

    def spy(*a, **k):
        called["yes"] = True
        return orig(*a, **k)

    monkeypatch.setattr(native_mod, "load_obj_native", spy)
    res = ResourceManager(assets_root=os.path.dirname(APP_MESHES))
    mesh = res.load_mesh("meshes/ground.obj")
    assert mesh is not None and called.get("yes")
    assert list(res.mesh_routes.values()) == ["native"]


def test_disable_native_takes_the_python_loader(monkeypatch):
    from banggameengine_tpu_torch.scene.resources import ResourceManager

    monkeypatch.setenv("BANG_DISABLE_NATIVE", "1")
    monkeypatch.delenv("BANG_ASSETS_DIR", raising=False)
    res = ResourceManager(assets_root=os.path.dirname(APP_MESHES))
    mesh = res.load_mesh("meshes/character.obj")
    assert mesh is not None
    assert list(res.mesh_routes.values()) == ["python"]


def test_missing_file_returns_none():
    assert load_obj_native("/nonexistent/x.obj") is None


def _tree(root, skip=(), skip_files=()):
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs
                   if x != "__pycache__" and os.path.join(d, x) not in skip]
        for f in files:
            if f not in skip_files:
                p = os.path.join(d, f)
                out[p] = os.stat(p).st_mtime_ns
    return out


def test_build_writes_only_under_the_ports_build_dir():
    port = os.path.join(REPO, "banggameengine_tpu_torch")
    build_dir = os.path.join(port, "_build")
    jax_native = os.path.join(REPO, "banggameengine_tpu", "native")

    def snapshot():
        # the JAX package's own library is its tests' to build
        return (_tree(port, skip=(build_dir,)),
                _tree(jax_native, skip_files=("libbangnative.so",)))

    before = snapshot()
    path = build_native(force=True)
    assert path == LIB_PATH
    assert os.path.abspath(path).startswith(build_dir + os.sep)
    assert snapshot() == before
