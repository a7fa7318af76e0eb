"""The port's scene-file path against the JAX package's, on the CPU.

- The PNG decoder against PIL on generated images of each colour type (0,
  2, 3, 4, 6; with and without ``tRNS``) and each of the five row filters,
  equal; anything else falls back to the checker with a warning.
- The OBJ loader against JAX's on the files of
  ``tests/test_scene_pipeline.py`` and the asset tree's meshes, equal.
- ``parse_scene_json`` and ``build_scene`` on ``tests/data/app_assets``
  against JAX's: integer and boolean arrays equal, floats within 1e-6
  (measured: all equal, the rotated child's quaternion and world matrix
  too), over every field of ``StaticScene``,
  ``WorldState`` and ``RenderScene``, and ``logical_ids``,
  ``entity_names`` and ``counts``.
- The resource manager: the lookup order (``BANG_ASSETS_DIR`` first), the
  caches and their statistics, as JAX's.

Both packages read meshes through the Python OBJ loader
(``BANG_DISABLE_NATIVE=1``; the port has no other).
"""

import dataclasses
import io
import logging
import os
import struct
import textwrap
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from banggameengine_tpu.physics.config import (
    load_physics_config as jax_load_physics_config,
)
from banggameengine_tpu.scene import obj_loader as jax_obj
from banggameengine_tpu.scene.build import build_scene as jax_build_scene
from banggameengine_tpu.scene.resources import (
    ResourceManager as JaxResourceManager,
)
from banggameengine_tpu.scene.schema import (
    parse_scene_json as jax_parse_scene_json,
)
from banggameengine_tpu_torch import convert
from banggameengine_tpu_torch.physics.config import load_physics_config
from banggameengine_tpu_torch.scene import obj_loader
from banggameengine_tpu_torch.scene.build import build_scene
from banggameengine_tpu_torch.scene.resources import ResourceManager
from banggameengine_tpu_torch.scene.schema import parse_scene_json
from banggameengine_tpu_torch.scene.textures import (
    decode_png_rgba8,
    encode_png_rgba8,
    load_texture_rgba8,
    make_checker_rgba8,
)
from test_torch_app_golden import ASSETS

FLOAT_ATOL = 1e-6


@pytest.fixture(autouse=True)
def python_obj_loader(monkeypatch):
    monkeypatch.setenv("BANG_DISABLE_NATIVE", "1")
    monkeypatch.delenv("BANG_ASSETS_DIR", raising=False)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _image(seed: int, h: int = 19, w: int = 23) -> np.ndarray:
    """Smooth gradients (PIL picks Sub, Up and Paeth rows for them) with
    a band of noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 7 + yy * 11) % 256, (xx * xx + yy) % 256,
                    (yy * 5) % 256, (xx * 3) % 256], -1).astype(np.uint8)
    img[5:9] = rng.integers(0, 256, (4, w, 4), dtype=np.uint8)
    return img


def _pil_png(im: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "PNG", **kw)
    return buf.getvalue()


def _pil_rgba(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGBA"))


def _pil_images():
    img = _image(0)
    key_rgb = tuple(int(v) for v in img[0, 0, :3])
    pal = Image.fromarray(img[..., :3]).quantize(colors=64)
    return {
        "grey": _pil_png(Image.fromarray(img[..., 0], "L")),
        "grey-trns": _pil_png(Image.fromarray(img[..., 0], "L"),
                              transparency=int(img[0, 0, 0])),
        "rgb": _pil_png(Image.fromarray(img[..., :3], "RGB")),
        "rgb-trns": _pil_png(Image.fromarray(img[..., :3], "RGB"),
                             transparency=key_rgb),
        "palette": _pil_png(pal),
        "palette-trns": _pil_png(pal, transparency=bytes(range(0, 200, 7))),
        "grey-alpha": _pil_png(Image.fromarray(img[..., :2], "LA")),
        "rgba": _pil_png(Image.fromarray(img, "RGBA")),
    }


@pytest.mark.parametrize("kind", sorted(_pil_images()))
def test_png_decoder_matches_pil(kind):
    data = _pil_images()[kind]
    got = decode_png_rgba8(data)
    assert got.dtype == np.uint8 and got.shape == (19, 23, 4)
    np.testing.assert_array_equal(got, _pil_rgba(data))


def _filtered_png(img: np.ndarray) -> bytes:
    """An RGBA PNG whose rows cycle through filters 0..4 (PIL's encoder
    never picks Average, so the rows are filtered here)."""
    h, w, _ = img.shape
    raw = img.reshape(h, w * 4).astype(np.int32)
    out = bytearray()
    for y in range(h):
        kind, line = y % 5, raw[y]
        up = raw[y - 1] if y else np.zeros_like(line)
        left = np.concatenate([np.zeros(4, np.int32), line[:-4]])
        ul = np.concatenate([np.zeros(4, np.int32), up[:-4]])
        if kind == 0:
            pred = np.zeros_like(line)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out.append(kind)
        out += ((line - pred) % 256).astype(np.uint8).tobytes()

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


def test_png_decoder_every_row_filter():
    img = _image(1, h=25)
    data = _filtered_png(img)
    np.testing.assert_array_equal(_pil_rgba(data), img)
    np.testing.assert_array_equal(decode_png_rgba8(data), img)


def test_png_encoder_round_trips_through_pil():
    img = _image(2)
    data = encode_png_rgba8(img)
    np.testing.assert_array_equal(_pil_rgba(data), img)
    np.testing.assert_array_equal(decode_png_rgba8(data), img)


def test_undecodable_texture_falls_back_to_the_checker(tmp_path, caplog):
    """A 16-bit PNG, a JPEG and a PNG with a broken CRC: the decoder
    refuses each, and the resource manager warns and returns the
    checker, as the JAX package does for a file PIL cannot read."""
    deep = tmp_path / "deep.png"
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 999
                    ).save(deep)
    jpeg = tmp_path / "photo.jpg"
    Image.fromarray(_image(3)[..., :3]).save(jpeg)
    broken = tmp_path / "broken.png"
    data = bytearray(_pil_images()["rgb"])
    data[40] ^= 0xFF
    broken.write_bytes(bytes(data))
    res = ResourceManager(str(tmp_path))
    for path in (deep, jpeg, broken):
        with pytest.raises(ValueError):
            load_texture_rgba8(str(path))
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="RES"):
            tex = res.load_texture(str(path))
        np.testing.assert_array_equal(tex, make_checker_rgba8())
        assert "checker fallback" in caplog.text
    assert res.tex_stats.misses == 3 and res.tex_stats.approx_bytes == 0


# ---------------------------------------------------------------------------
# OBJ
# ---------------------------------------------------------------------------

_OBJ_FILES = {
    "tri": ("tri.obj", textwrap.dedent("""
        v 0 0 0
        v 1 0 0
        v 0 1 0
        vt 0 0
        vt 1 0
        vt 0 1
        f 1/1 2/2 3/3
        """), {}),
    "quad": ("quad.obj", "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n",
             {}),
    "two": ("two.obj", textwrap.dedent("""
        mtllib m.mtl
        v 0 0 0
        v 1 0 0
        v 0 1 0
        usemtl red
        f 1 2 3
        usemtl blue
        f 1 3 2
        usemtl red
        f 2 1 3
        """), {"m.mtl": "newmtl red\nKd 1 0 0\nnewmtl blue\nKd 0 0 1\n"}),
}


def _assert_mesh_equal(a, b):
    for f in ("positions", "normals", "uvs", "colors", "indices"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert ([dataclasses.astuple(s) for s in a.submeshes]
            == [dataclasses.astuple(s) for s in b.submeshes])
    assert ([dataclasses.astuple(m) for m in a.materials]
            == [dataclasses.astuple(m) for m in b.materials])


@pytest.mark.parametrize("name", sorted(_OBJ_FILES))
def test_obj_loader_matches_jax(tmp_path, name):
    fname, text, extra = _OBJ_FILES[name]
    for k, v in extra.items():
        (tmp_path / k).write_text(v)
    (tmp_path / fname).write_text(text)
    path = str(tmp_path / fname)
    _assert_mesh_equal(obj_loader.load_obj(path), jax_obj.load_obj(path))


@pytest.mark.parametrize("mesh", ["character", "ground"])
def test_asset_meshes_match_jax(mesh):
    obj = os.path.join(ASSETS, "meshes", f"{mesh}.obj")
    _assert_mesh_equal(obj_loader.load_obj(obj), jax_obj.load_obj(obj))
    mtl = os.path.join(ASSETS, "meshes", f"{mesh}.mtl")
    assert ({k: dataclasses.asdict(m) for k, m in obj_loader.parse_mtl(
        mtl).items()}
            == {k: dataclasses.asdict(m)
                for k, m in jax_obj.parse_mtl(mtl).items()})


def test_builtin_meshes_match_jax():
    _assert_mesh_equal(obj_loader.make_cube(), jax_obj.make_cube())
    _assert_mesh_equal(obj_loader.make_ground_plane(),
                       jax_obj.make_ground_plane())


# ---------------------------------------------------------------------------
# scene build
# ---------------------------------------------------------------------------

def _np_fields(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _assert_arrays_match(port: dict, ref: dict, what: str):
    assert sorted(port) == sorted(ref), what
    for name, a in ref.items():
        b = port[name]
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what}.{name}"
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=0, atol=FLOAT_ATOL,
                                       err_msg=f"{what}.{name}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{what}.{name}")


@pytest.fixture(scope="module")
def builds():
    scene = os.path.join(ASSETS, "scenes", "demo.json")
    cfg = os.path.join(ASSETS, "config", "physics.json")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BANG_DISABLE_NATIVE", "1")
        mp.delenv("BANG_ASSETS_DIR", raising=False)
        jres, tres = JaxResourceManager(ASSETS), ResourceManager(ASSETS)
        jax_built = jax_build_scene(jax_parse_scene_json(scene), jres,
                                    jax_load_physics_config(cfg))
        port_built = build_scene(parse_scene_json(scene), tres,
                                 load_physics_config(cfg), device="cpu")
    return jax_built, port_built, jres, tres


def test_scene_desc_matches_jax():
    scene = os.path.join(ASSETS, "scenes", "demo.json")
    port, ref = parse_scene_json(scene), jax_parse_scene_json(scene)

    def plain(desc):
        return json_ready(dataclasses.asdict(desc))

    assert plain(port) == plain(ref)


def json_ready(obj):
    if isinstance(obj, dict):
        return {k: json_ready(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_ready(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return [obj.dtype.str, obj.tolist()]
    return obj


@pytest.mark.parametrize("part", ["static", "initial_state", "render"])
def test_build_scene_matches_jax(builds, part):
    jax_built, port_built, _, _ = builds
    to_np = {"static": convert.static_scene_to_numpy,
             "initial_state": convert.world_state_to_numpy,
             "render": convert.render_scene_to_numpy}[part]
    _assert_arrays_match(to_np(getattr(port_built, part)),
                         _np_fields(getattr(jax_built, part)), part)


def test_build_scene_bookkeeping_matches_jax(builds):
    jax_built, port_built, jres, tres = builds
    assert port_built.logical_ids == jax_built.logical_ids
    assert port_built.entity_names == jax_built.entity_names
    assert port_built.counts == jax_built.counts
    assert (dataclasses.asdict(port_built.config)
            == dataclasses.asdict(jax_built.config))
    for lid in ("cj", "checkpoint", "ground", "cj_hat", "nobody"):
        assert port_built.find_entity(lid) == jax_built.find_entity(lid)
    for stats in ("tex_stats", "mesh_stats", "mat_stats"):
        assert (dataclasses.astuple(getattr(tres, stats))
                == dataclasses.astuple(getattr(jres, stats))), stats
    assert tres.print_stats() == jres.print_stats()
    # the scene: the textured ground, the character's two MTL materials,
    # the hat's override, a child under the character
    render = port_built.render
    assert render.textures.shape[0] == 3 and int(render.tri_valid.sum()) == 26
    assert int(port_built.static.parent[3]) == 0
    assert port_built.initial_state.pos.device == torch.device("cpu")


def test_runtime_crud_is_not_ported(builds):
    """Runtime CRUD, once refused (ROADMAP item 18), now edits a built
    scene (``tests/test_torch_lifecycle.py`` holds it to JAX): on a copy
    of the build, a spawn takes the lowest free slot, a reparent moves
    the hat to the root, a despawn frees the slot."""
    _, port_built, _, _ = builds
    built = dataclasses.replace(
        port_built, static=dataclasses.replace(port_built.static, **{
            f.name: getattr(port_built.static, f.name).clone()
            for f in dataclasses.fields(port_built.static)}),
        logical_ids=dict(port_built.logical_ids),
        entity_names=list(port_built.entity_names),
        counts=dict(port_built.counts))
    state = built.initial_state
    state, crate = built.spawn(state, name="crate", pos=(0.0, 3.0, 0.0))
    assert crate == 4 and bool(state.alive[crate])
    assert built.find_entity("crate") == crate
    built.reparent(state, 3, None)
    assert int(built.static.parent[3]) == -1
    state = built.despawn(state, crate)
    assert not bool(state.alive[crate]) and built.find_entity("crate") == -1
    assert int(port_built.static.parent[3]) == 0


def test_resource_lookup_order_and_cache(tmp_path, monkeypatch):
    """``BANG_ASSETS_DIR`` wins over the explicit root, as in the JAX
    package; a second load is a cache hit; a reload evicts."""
    monkeypatch.setenv("BANG_ASSETS_DIR", str(tmp_path))
    assert ResourceManager(ASSETS).get_assets_root() == str(tmp_path)
    assert (JaxResourceManager(ASSETS).get_assets_root()
            == ResourceManager(ASSETS).get_assets_root())
    monkeypatch.delenv("BANG_ASSETS_DIR")
    res = ResourceManager(ASSETS)
    assert res.get_assets_root() == os.path.abspath(ASSETS)
    a = res.load_texture("textures/grass.png")
    b = res.load_texture(os.path.join(ASSETS, "textures", "grass.png"))
    assert a is b and a.shape == (16, 16, 4)
    assert (res.tex_stats.hits, res.tex_stats.misses) == (1, 1)
    assert res.tex_stats.approx_bytes == 16 * 16 * 4
    assert res.load_mesh("meshes/missing.obj") is None
    assert res.reload("textures/grass.png")
    assert res.load_texture("textures/grass.png") is not a
