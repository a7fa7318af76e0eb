"""The app's last fused frame at 1280x720, the port against the JAX golden.

``tests/data/app_jax_golden.npz`` keeps the JAX app's last fused state
(its world matrices), camera and the frame the fused tick draws from them
at 1280x720 (``test_torch_app_golden.full_frame``).  Here the JAX render
is run again and must give the stored frame, and the port renders the
same world and camera through its fused tick's call (the plain versions
of its walk and resolve kernels): within 1 level on >= 99.9 % of pixels,
the sky mask equal elsewhere, as ``chip_smoke.py`` phase 17 holds the
card's frame after the whole track.
"""

import numpy as np
import pytest
import torch

from banggameengine_tpu_torch.render.pipeline import render_frame
from banggameengine_tpu_torch.render.shading import LightParams
from banggameengine_tpu_torch.scene.build import build_scene
from banggameengine_tpu_torch.scene.resources import ResourceManager
from banggameengine_tpu_torch.scene.schema import parse_scene_json
from test_torch_app_golden import (
    ASSETS,
    FULL,
    GOLDEN_NPZ,
    full_frame,
    one_torch_thread,  # noqa: F401 (the module's pytestmark uses it)
)
from test_torch_render_frame import SKY, frame_agreement

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def stored():
    return dict(np.load(GOLDEN_NPZ))


def test_full_frame_golden_is_current(stored, monkeypatch):
    monkeypatch.setenv("BANG_DISABLE_NATIVE", "1")
    monkeypatch.delenv("BANG_ASSETS_DIR", raising=False)
    assert np.array_equal(full_frame(stored), stored["fused_full"]), (
        "app_jax_golden.npz's fused_full is stale: run PYTHONPATH=. "
        "JAX_PLATFORMS=cpu python tests/test_torch_app_golden.py")


def test_full_frame_matches_jax(stored, monkeypatch):
    monkeypatch.delenv("BANG_ASSETS_DIR", raising=False)
    built = build_scene(parse_scene_json(f"{ASSETS}/scenes/demo.json"),
                        ResourceManager(ASSETS), device="cpu")
    t = torch.as_tensor
    img = render_frame(
        built.render, t(stored["fused_world"]), t(stored["fused_view"]),
        t(stored["fused_proj_full"]), t(stored["fused_cam_pos"]),
        LightParams.default("cpu"), width=FULL[0], height=FULL[1],
        bin_capacity=2048).numpy()
    ref = stored["fused_full"]
    assert img.shape == ref.shape == (FULL[1], FULL[0], 4)
    off, sky_off = frame_agreement(img, ref)
    assert off <= 0.001 * FULL[0] * FULL[1], (
        f"{off} pixels differ by more than 1 level")
    assert sky_off == 0, f"sky mask differs at {sky_off} other pixels"
    sky = (img == SKY).all(-1)
    assert 0.05 < sky.mean() < 0.95
