"""The port's whole frame against the JAX package on the CPU.

The showcase scene (:func:`build_showcase_render`, numpy, the same arrays
on both sides) is rendered at 256x160 by the JAX package
(``make_render_fn(..., raster_backend="walk")``: its walk kernel in
interpret mode, its XLA one-hot resolve) and by the port (the plain
versions of its kernels).

Tolerances: the u8 frame within 1 level on >= 99.9 % of pixels, the sky
mask equal outside the pixels that differ by more than that, the
depth-only frame within 1e-6 on >= 99.9 % of pixels.  JAX's CPU compiler
fuses multiply-adds and PyTorch's eager ops do not, so a colour may round
to the next level and a pixel exactly on a triangle edge may flip.

``JAX_PLATFORMS=cpu python tests/test_torch_render_frame.py`` rewrites the
JAX golden frame that ``chip_smoke.py`` holds the port against on the GPU.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banggameengine_tpu.render.pipeline import make_render_fn as jax_render_fn
from banggameengine_tpu.scene.build import RenderScene as JaxRenderScene
from banggameengine_tpu_torch import convert
from banggameengine_tpu_torch.render import raster as rz
from banggameengine_tpu_torch.render.pipeline import (
    make_render_fn,
    render_frame,
)
from banggameengine_tpu_torch.scene.synthetic import build_showcase_render

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "showcase_jax_golden.npz")
SEED, W, H = 0, 256, 160
SKY = (0x88, 0xAA, 0xFF, 0xFF)


def frame_agreement(port: np.ndarray, ref: np.ndarray) -> tuple[int, int]:
    """(pixels whose channels differ by more than 1 level, pixels whose sky
    mask differs among the rest) of two u8[H, W, 4] frames."""
    off = np.abs(port.astype(np.int32) - ref.astype(np.int32)).max(-1) > 1
    sky_p = (port == SKY).all(-1)
    sky_r = (ref == SKY).all(-1)
    return int(off.sum()), int((sky_p != sky_r)[~off].sum())


def _camera_arrays(sc):
    return dict(view=sc.camera.view_matrix("cpu").numpy(),
                proj=sc.camera.proj_matrix(W / H, "cpu").numpy(),
                cam_pos=sc.camera.position.copy())


def _jax_render(sc, cam, depth_only=False):
    rs = JaxRenderScene(**{k: jnp.asarray(v) for k, v in sc.render.items()})
    fn = jax_render_fn(rs, W, H, depth_only=depth_only,
                       raster_backend="walk")
    return np.array(fn(jnp.asarray(sc.world), jnp.asarray(cam["view"]),
                       jnp.asarray(cam["proj"]), jnp.asarray(cam["cam_pos"])))


def _golden() -> dict:
    sc = build_showcase_render(SEED)
    cam = _camera_arrays(sc)
    return dict(frame=_jax_render(sc, cam), depth=_jax_render(sc, cam, True),
                seed=np.int32(SEED), width=np.int32(W), height=np.int32(H),
                **cam)


@pytest.fixture(scope="module")
def jax_golden():
    return _golden()


@pytest.fixture(scope="module")
def port_render():
    sc = build_showcase_render(SEED)
    cam = {k: torch.as_tensor(v) for k, v in _camera_arrays(sc).items()}
    rs = convert.render_scene_from_numpy(sc.render, "cpu")
    fn = make_render_fn(rs, W, H, return_depth=True)
    frame, depth = fn(torch.as_tensor(sc.world), cam["view"], cam["proj"],
                      cam["cam_pos"])
    depth_only = make_render_fn(rs, W, H, depth_only=True)(
        torch.as_tensor(sc.world), cam["view"], cam["proj"], cam["cam_pos"])
    return frame.numpy(), depth.numpy(), depth_only.numpy()


def test_frame_matches_jax(jax_golden, port_render):
    frame, _, _ = port_render
    ref = jax_golden["frame"]
    assert frame.dtype == np.uint8 and frame.shape == (H, W, 4)
    off, sky_off = frame_agreement(frame, ref)
    assert off <= 0.001 * H * W, f"{off} pixels differ by more than 1 level"
    assert sky_off == 0, f"sky mask differs at {sky_off} other pixels"
    sky = (frame == SKY).all(-1)
    assert 0.2 < sky.mean() < 0.8                 # sky and scene both there


def test_depth_only_matches_jax(jax_golden, port_render):
    _, depth, depth_only = port_render
    assert np.array_equal(depth, depth_only)
    assert depth_only.dtype == np.float32 and depth_only.shape == (H, W)
    off = np.abs(depth_only - jax_golden["depth"]) > 1e-6
    assert off.mean() <= 0.001, f"{off.sum()} depth pixels differ"
    assert (depth_only == 1.0).any() and (depth_only < 1.0).any()


def test_chip_smoke_golden_is_current(jax_golden):
    with np.load(GOLDEN) as stored:
        assert sorted(stored.files) == sorted(jax_golden)
        for k, v in jax_golden.items():
            assert np.array_equal(stored[k], v), (
                f"tests/data/showcase_jax_golden.npz is stale in {k}: run "
                "JAX_PLATFORMS=cpu python tests/test_torch_render_frame.py")


def test_showcase_tiles_need_the_wide_resolve():
    """At 1920x1080 the character stand-in puts more than 48 local
    triangles in some tiles (the resolve needs the full walk width there)
    and no tile overflows the walk's 256 local slots."""
    sc = build_showcase_render(SEED)
    rs = convert.render_scene_from_numpy(sc.render, "cpu")
    t = torch.as_tensor
    view = sc.camera.view_matrix("cpu")
    proj = sc.camera.proj_matrix(1920 / 1080, "cpu")
    _, clip = rz.transform_vertices(rs.v_pos, rs.v_entity, t(sc.world), view,
                                    proj)
    n = clip.shape[0] // 3
    sub_clip, _, sub_valid = rz.clip_near_plane(clip.reshape(n, 3, 4),
                                                rs.tri_valid)
    tri = rz.setup_triangles(sub_clip.reshape(-1, 3, 4),
                             sub_valid.reshape(-1), 1920, 1080)
    _, counts, local, overflow, _ = rz.bin_triangles(tri, 1920, 1088,
                                                     k_local=2048)
    assert int((local > 48).sum()) > 0
    assert int(local.max()) <= rz.HEAVY_CAPACITY
    assert int(overflow) == 0
    assert int((counts - local).max()) <= rz.K_GLOBAL


def test_unported_options_raise():
    sc = build_showcase_render(SEED)
    rs = convert.render_scene_from_numpy(sc.render, "cpu")
    cam = {k: torch.as_tensor(v) for k, v in _camera_arrays(sc).items()}
    args = (rs, torch.as_tensor(sc.world), cam["view"], cam["proj"],
            cam["cam_pos"])
    for kw in (dict(raster_backend="xla"), dict(raster_backend="auto")):
        with pytest.raises(ValueError, match="ROADMAP"):
            render_frame(*args, width=W, height=H, **kw)
    # the tiled shade over the "tile" raster is ported (item 14;
    # tests/test_torch_tiled_tile.py holds it against JAX): on the showcase
    # it shades the flat route's planes to the same frame
    tiled = render_frame(*args, width=W, height=H, shade_mode="tiled",
                         raster_backend="tile")
    flat = render_frame(*args, width=W, height=H, shade_mode="flat",
                        raster_backend="tile")
    assert torch.equal(tiled, flat)
    # the flat shade needs the full carry, which the walk does not keep
    with pytest.raises(ValueError, match="tile"):
        render_frame(*args, width=W, height=H, shade_mode="flat")


def test_port_imports_without_jax():
    """The card's machine has no JAX and no PIL: every module of the port
    imports with ``jax``, the JAX package and ``PIL`` blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['banggameengine_tpu'] = None\n"
        "sys.modules['PIL'] = None\n"
        "import banggameengine_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert 'banggameengine_tpu_torch.render.pipeline' in names\n"
        "assert 'banggameengine_tpu_torch.app.application' in names\n"
        "assert 'banggameengine_tpu_torch.physics.raycast' in names\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 40


if __name__ == "__main__":
    np.savez_compressed(GOLDEN, **_golden())
    print(f"wrote {GOLDEN}")
