"""Raycasts, the physics facade and the interpolated frame, the port
against the JAX package on the CPU.

- ``raycast_closest`` and ``raycast_all``: seeded rays aimed at boxes and
  capsules (and some at nothing) through a seeded world with rotations,
  layers, dead and collision-less entities; the entity and every hit flag
  equal, distances, points and normals within 1e-5 (measured: equal).
- The facade (``physics.api``) over the port's Application on the asset
  tree: straight down from (0, 10, -5) it hits the ground box at y = 0.99,
  as the JAX package's verify drive does.
- ``interpolated_world`` between two seeded states within 1e-6, and one
  ``make_interp_render_fn`` frame at 128x64 within 1 level of JAX's on
  >= 99.9 % of pixels with the sky mask equal elsewhere.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banggameengine_tpu.engine import interpolated_world as jax_interpolated
from banggameengine_tpu.physics import raycast as jrc
from banggameengine_tpu.render.pipeline import (
    make_interp_render_fn as jax_interp_render_fn,
)
from banggameengine_tpu.scene.build import RenderScene as JaxRenderScene
from banggameengine_tpu.scene.synthetic import (
    build_falling_boxes as jax_build_falling_boxes,
)
from banggameengine_tpu_torch import convert, math3d
from banggameengine_tpu_torch.engine import interpolated_world
from banggameengine_tpu_torch.physics import api
from banggameengine_tpu_torch.physics import raycast as trc
from banggameengine_tpu_torch.render.camera import Camera
from banggameengine_tpu_torch.render.pipeline import make_interp_render_fn
from banggameengine_tpu_torch.scene.synthetic import build_box_render
from test_torch_app_golden import ASSETS, one_torch_thread  # noqa: F401
from test_torch_render_frame import SKY, frame_agreement

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL = 1e-5
N = 24


def _world(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(N, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return dict(
        pos=rng.uniform(-6, 6, (N, 3)).astype(np.float32),
        quat=q,
        shape_type=rng.choice(np.array([0, 1, 2], np.int8), N,
                              p=[0.1, 0.5, 0.4]),
        size=rng.uniform(0.3, 1.5, (N, 3)).astype(np.float32),
        layer=rng.choice(np.array([1, 2, 4], np.uint32), N),
        alive=rng.random(N) < 0.9,
        has_collision=rng.random(N) < 0.9,
    )


def _rays(seed: int, world: dict, n: int = 48):
    """Rays from a shell around the world toward a random entity's centre
    (3 in 4) or a random point, with mixed masks and lengths; the ground
    plane on for every other ray."""
    rng = np.random.default_rng(seed + 100)
    for k in range(n):
        o = rng.normal(size=3).astype(np.float32)
        o = o / np.linalg.norm(o) * 12.0
        if k % 4:
            target = world["pos"][rng.integers(N)]
        else:
            target = rng.uniform(-6, 6, 3).astype(np.float32)
        d = (target - o).astype(np.float32)
        d /= np.linalg.norm(d)
        mask = int(rng.choice([1, 6, 0xFFFFFFFF, 0xFFFFFFFF]))
        yield (o, d.astype(np.float32), float(rng.choice([9.0, 30.0])), mask,
               bool(k % 2))


def _args_jax(w):
    return (jnp.asarray(w["pos"]), jnp.asarray(w["quat"]),
            jnp.asarray(w["shape_type"]), jnp.asarray(w["size"]),
            jnp.asarray(w["layer"]), jnp.asarray(w["alive"]),
            jnp.asarray(w["has_collision"]))


def _args_port(w):
    return (torch.as_tensor(w["pos"]), torch.as_tensor(w["quat"]),
            torch.as_tensor(w["shape_type"]), torch.as_tensor(w["size"]),
            torch.as_tensor(w["layer"].view(np.int32)),
            torch.as_tensor(w["alive"]), torch.as_tensor(w["has_collision"]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_raycast_closest_matches_jax(seed):
    w = _world(seed)
    hits = 0
    for o, d, max_dist, mask, ground in _rays(seed, w):
        jh = jrc.raycast_closest(jnp.asarray(o), jnp.asarray(d),
                                 jnp.float32(max_dist), jnp.uint32(mask),
                                 *_args_jax(w), ground_enabled=ground)
        th = trc.raycast_closest(torch.as_tensor(o), torch.as_tensor(d),
                                 max_dist, mask, *_args_port(w),
                                 ground_enabled=ground)
        assert int(th.entity) == int(jh.entity)
        assert bool(th.hit) == bool(jh.hit)
        hits += int(jh.entity) >= 0
        for f in ("point", "normal", "distance"):
            np.testing.assert_allclose(getattr(th, f).numpy(),
                                       np.asarray(getattr(jh, f)),
                                       rtol=0, atol=ATOL, err_msg=f)
    assert hits >= 10       # 12-22 of the 48 rays land on an entity


@pytest.mark.parametrize("seed", [3, 4])
def test_raycast_all_matches_jax(seed):
    w = _world(seed)
    for o, d, max_dist, mask, ground in _rays(seed, w, n=16):
        jt, jhit, jn, jtg, jhg = jrc.raycast_all(
            jnp.asarray(o), jnp.asarray(d), jnp.float32(max_dist),
            jnp.uint32(mask), *_args_jax(w), ground_enabled=ground)
        tt, thit, tn, ttg, thg = trc.raycast_all(
            torch.as_tensor(o), torch.as_tensor(d), max_dist, mask,
            *_args_port(w), ground_enabled=ground)
        np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
        assert bool(thg) == bool(jhg)
        hit = np.asarray(jhit)
        np.testing.assert_allclose(tt.numpy()[hit], np.asarray(jt)[hit],
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(tn.numpy()[hit], np.asarray(jn)[hit],
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(float(ttg), float(jtg), rtol=0, atol=ATOL)


def test_facade_raycasts_the_active_app(monkeypatch):
    from banggameengine_tpu_torch.app.application import Application

    monkeypatch.delenv("BANG_ASSETS_DIR", raising=False)
    app = Application(assets_root=ASSETS, width=64, height=32, device="cpu")
    assert api.get_active_system() is app and api.get_event_bus() is app.bus
    ground = app.built.find_entity("ground")
    hit = api.raycast((0.0, 10.0, -5.0), (0.0, -2.0, 0.0), mask=1)
    assert int(hit.entity) == ground
    np.testing.assert_allclose(hit.point.numpy(), [0.0, 0.99, -5.0],
                               atol=1e-5)
    assert float(hit.distance) == pytest.approx(9.01, abs=1e-5)
    # every hit sorted by distance: the character's capsule (spawned at
    # y = 7 above (0, -5), on the character layer), then the box, then
    # the ground plane y = 0 under it
    hits = api.raycast_all((0.0, 10.0, -5.0), (0.0, -1.0, 0.0))
    assert [int(h.entity) for h in hits] == [app.built.find_entity("cj"),
                                            ground, trc.GROUND_ENTITY]
    assert [float(h.distance) for h in hits] == sorted(
        float(h.distance) for h in hits)
    assert api.raycast((0.0, 10.0, -5.0), (0.0, 1.0, 0.0)) is None
    api.set_active_system(None)
    assert api.raycast((0, 10, 0), (0, -1, 0)) is None
    assert api.raycast_all((0, 10, 0), (0, -1, 0)) == []


def _two_states():
    """A 12-box world's state and the next one, rotations and all, as
    numpy dicts (the second moved and turned by seeded amounts)."""
    js, jst = jax_build_falling_boxes(12, seed=5, spread=3.0,
                                      with_character=True)
    a = {f.name: np.asarray(getattr(js, f.name))
         for f in dataclasses.fields(js)}
    rng = np.random.default_rng(6)
    b = dict(a)
    b["pos"] = (a["pos"] + rng.normal(0, 0.3, a["pos"].shape)).astype(
        np.float32)
    q = a["quat"] + rng.normal(0, 0.2, a["quat"].shape).astype(np.float32)
    q[3] = -q[3]       # one rotation across the hemisphere
    b["quat"] = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(
        np.float32)
    st = {f.name: np.asarray(getattr(jst, f.name))
          for f in dataclasses.fields(jst)}
    return js, jst, a, b, st


def _jax_state(js, arrays):
    return dataclasses.replace(js, **{k: jnp.asarray(v)
                                      for k, v in arrays.items()})


@pytest.mark.parametrize("alpha", [0.0, 0.3, 1.0])
def test_interpolated_world_matches_jax(alpha):
    js, jst, a, b, st = _two_states()
    ref = jax_interpolated(_jax_state(js, a), _jax_state(js, b), alpha, jst)
    got = interpolated_world(convert.world_state_from_numpy(a, "cpu"),
                             convert.world_state_from_numpy(b, "cpu"),
                             alpha, convert.static_scene_from_numpy(st, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_quat_nlerp_takes_the_short_way():
    a = torch.tensor([[0.0, 0.0, 0.0, 1.0]])
    b = -a                                       # the same rotation
    np.testing.assert_allclose(math3d.quat_nlerp(a, b, 0.5).numpy(),
                               a.numpy())


def test_interp_render_matches_jax():
    W, H = 128, 64
    js, jst, a, b, st = _two_states()
    static = convert.static_scene_from_numpy(st, "cpu")
    render = build_box_render(static)
    cam = Camera()
    cam.position[:] = (0.0, 4.0, -7.0)
    cam.set_yaw_pitch(np.pi / 2, -0.15)
    view, proj = cam.view_matrix("cpu"), cam.proj_matrix(W / H, "cpu")
    jfn = jax_interp_render_fn(
        JaxRenderScene(**{k: jnp.asarray(v) for k, v in render.items()}),
        W, H, bin_capacity=2048)
    ref = np.asarray(jfn(_jax_state(js, a), _jax_state(js, b), 0.4, jst,
                         jnp.asarray(view.numpy()), jnp.asarray(proj.numpy()),
                         jnp.asarray(cam.position)))
    fn = make_interp_render_fn(convert.render_scene_from_numpy(render, "cpu"),
                               W, H, bin_capacity=2048, return_depth=True)
    img, depth = fn(convert.world_state_from_numpy(a, "cpu"),
                    convert.world_state_from_numpy(b, "cpu"),
                    torch.tensor(0.4), static, view, proj,
                    torch.as_tensor(cam.position))
    img = img.numpy()
    assert img.shape == (H, W, 4) and depth.shape == (H, W)
    off, sky_off = frame_agreement(img, ref)
    assert off <= 0.001 * H * W, f"{off} pixels differ by more than 1 level"
    assert sky_off == 0, f"sky mask differs at {sky_off} other pixels"
    assert 0.05 < (img != SKY).any(-1).mean() < 0.95       # boxes in view
