"""The port's world-axis and entity-axis sharded modes on D = 1, 2 and 4
gloo ranks, against the JAX package on D of the 8 virtual CPU devices.

- The flat step with ``mesh=`` at 16 worlds of ``build_falling_boxes(8,
  with_character=True, with_trigger=True)``, 25 steps: bit-equal to the
  port's single-device flat step (each rank runs the same step on its own
  worlds), as ``tests/test_flat_manyworld.py:121`` holds JAX's.
- The router's layouts: 16 worlds give ``"flat"`` on one rank and
  ``"flat-sharded"`` on more; 10 worlds over 4 ranks give ``"vmapped"``
  (the flat factory's ``ValueError``); the JAX router's names at the same
  D.  Only the layout is checked, as ``tests/test_flat_manyworld.py:144-160``
  does.
- ``make_entity_sharded_contact_phase`` on the 24-box scene of
  ``tests/test_spatial_sharding.py:88``: velocities within the JAX test's
  bar (atol and rtol 1e-4) of the JAX phase at the same D, bit-equal
  across D (a row's arithmetic does not depend on its rank).
- ``dryrun_multichip(4, device="cpu")`` on the 4 ranks.
- The flat step with joints (IsaacGymEnvs' Ant, ``scene/ant.py``) with
  ``mesh=`` at 4 worlds, a call of 2 steps under seeded motor commands:
  each rank tiles the joint table over its own worlds, and the state and
  the joints' impulses are bit-equal to the single-device step's on the
  same worlds.  (The single-device step of W/D worlds, not of all W: on
  the CPU the joints' sums over a middle axis take another order at
  another count of worlds, 1.2e-7 m apart after 4 steps.)

Each D's ranks are spawned once, all three groups at once, through
``parallel.ranks.run_ranks``; they import neither JAX nor the JAX
package (this module imports neither at module level).
"""

import dataclasses
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from banggameengine_tpu_torch import convert
from banggameengine_tpu_torch.parallel import manyworld, ranks
from banggameengine_tpu_torch.state import (
    BODY_DYNAMIC, COMP_CHARACTER, COMP_COLLIDER, InputFrame)

DS = (1, 2, 4)
FLAT_WORLDS, FLAT_STEPS = 16, 25
ANT_WORLDS, ANT_CALLS = 4, 1
PHASE_TOL = 1e-4
DT = 1 / 120


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _jax_boxes():
    from banggameengine_tpu.scene.synthetic import build_falling_boxes

    return build_falling_boxes(8, with_character=True, with_trigger=True)


def _phase_inputs(state: dict, static: dict) -> dict:
    """The contact phase's inputs of ``tests/test_spatial_sharding.py``:
    the bodies lowered to the ground and falling at 1 m/s."""
    n = state["alive"].shape[0]
    alive = state["alive"]
    pos = state["pos"].copy()
    pos[:, 1] = np.where(alive, 0.45 + 0.1 * (np.arange(n) % 3), pos[:, 1])
    vel = state["lin_vel"].copy()
    vel[:, 1] = np.where(alive, -1.0, 0.0)
    comp = state["comp_mask"].astype(np.int64)
    has_col = (comp & (COMP_COLLIDER | COMP_CHARACTER)) != 0
    solid = alive & has_col & ((comp & COMP_CHARACTER) == 0)
    is_dyn = (static["body_type"] == BODY_DYNAMIC) & alive
    return dict(pos=pos.astype(np.float32), quat=state["quat"], vel=vel,
                ang=state["ang_vel"], is_dyn=is_dyn, solid=solid)


def _jax_phase_scene():
    from banggameengine_tpu.scene.synthetic import build_falling_boxes

    state, static = build_falling_boxes(24, seed=5, spread=4.0)
    return _np(state), _np(static)


def modes_rank(rank, world_size, boxes, phase_scene, phase_in):
    """One rank: the flat step on the world mesh, the router's layouts,
    the entity-sharded contact phase, and on 4 ranks the dry run."""
    from banggameengine_tpu_torch.parallel import dryrun_multichip, spatial

    state_np, static_np = boxes
    ts = convert.world_state_from_numpy(state_np, "cpu")
    tst = convert.static_scene_from_numpy(static_np, "cpu")
    mesh = manyworld.make_world_mesh(device_type="cpu")
    out = {}
    bs = manyworld.replicate_state(ts, FLAT_WORLDS)
    bi = manyworld.replicate_input(InputFrame.zero("cpu"), FLAT_WORLDS)
    flat = manyworld.make_flat_many_world_step(
        tst, FLAT_WORLDS, ts.comp_mask, num_steps=FLAT_STEPS, mesh=mesh)
    res = flat(manyworld.shard_batched(bs, mesh),
               manyworld.shard_batched(bi, mesh))
    out["flat_local_worlds"] = int(res.pos.to_local().shape[0])
    out["flat"] = convert.world_state_to_numpy(ranks.full(res))
    out["layouts"] = [
        manyworld.make_many_world_step(tst, mesh, ts.comp_mask, w,
                                       verbose=False)[1]
        for w in (FLAT_WORLDS, 10)]

    out["ant"] = _ant_flat(mesh)

    pst = convert.static_scene_from_numpy(phase_scene, "cpu")
    emesh = ranks.make_mesh(spatial.AXIS, "cpu")
    phase = spatial.make_entity_sharded_contact_phase(pst, emesh)
    t = {k: torch.as_tensor(v) for k, v in phase_in.items()}
    v, w = phase(t["pos"], t["quat"], t["vel"], t["ang"], t["is_dyn"],
                 t["solid"], DT)
    out["phase"] = (v.numpy(), w.numpy())
    if world_size == 4:
        out["dryrun"] = dryrun_multichip(4, device="cpu")
    out["jax_free"] = not any(
        m == "jax" or m.startswith(("jax.", "banggameengine_tpu."))
        or m == "banggameengine_tpu" for m in sys.modules)
    return out


def _ant_flat(mesh=None, worlds=slice(None)):
    """The jointed flat step of ``ANT_WORLDS`` Ant worlds (seeded starts
    and commands), on the world mesh, or on one device on ``worlds``
    alone: the whole positions and joint impulses after ``ANT_CALLS``
    calls."""
    import json
    import os

    from banggameengine_tpu_torch.physics import joints as jt
    from banggameengine_tpu_torch.scene.ant import build_ant_worlds
    from torch.distributed.tensor import Shard

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "portbench", "configs",
        "isaacgym-ant4k.json")
    with open(path) as f:
        cfg = json.load(f)
    aw = build_ant_worlds(cfg["scene"], cfg["physics"],
                          num_worlds=ANT_WORLDS, seed=5, device="cpu")
    state = dataclasses.replace(aw.state, **{
        f.name: getattr(aw.state, f.name)[worlds]
        for f in dataclasses.fields(aw.state)})
    w = state.pos.shape[0]
    step = manyworld.make_flat_many_world_step(
        aw.static, w, aw.state.comp_mask[0], num_steps=2, mesh=mesh,
        joints=aw.joints)
    js = jt.make_joint_state(aw.joints, w)
    g = torch.Generator().manual_seed(9)
    commands = [torch.randn((ANT_WORLDS, 8), generator=g).clamp(-1, 1)[
        worlds] for _ in range(ANT_CALLS)]
    if mesh is not None:
        state = manyworld.shard_batched(state, mesh)
        js.impulse = ranks.distribute(js.impulse, mesh, Shard(0))
        commands = [ranks.distribute(c, mesh, Shard(0)) for c in commands]
    for command in commands:
        state, js = step(state, InputFrame.zero("cpu"), js, command)
    return (ranks.replicated(state.pos).numpy(),
            ranks.replicated(js.impulse).numpy())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    boxes = tuple(_np(o) for o in _jax_boxes())
    phase_scene = _jax_phase_scene()
    phase_in = _phase_inputs(*phase_scene)

    # the directories are made here, before the threads: pytest's temp
    # factory is not thread-safe
    dirs = {d: str(tmp_path_factory.mktemp(f"d{d}")) for d in DS}

    def launch(d):
        return ranks.run_ranks(
            modes_rank, d, boxes, phase_scene[1], phase_in, device="cpu",
            store_dir=dirs[d])

    with ThreadPoolExecutor(len(DS)) as pool:
        results = dict(zip(DS, pool.map(launch, DS)))
    for res in results.values():
        assert all(r["jax_free"] for r in res), "a rank imported JAX"
    return dict(results=results, boxes=boxes, phase_scene=phase_scene,
                phase_in=phase_in)


@pytest.mark.parametrize("d", DS)
def test_flat_mesh_bit_equal_to_single_device(d, runs):
    state_np, static_np = runs["boxes"]
    ts = convert.world_state_from_numpy(state_np, "cpu")
    tst = convert.static_scene_from_numpy(static_np, "cpu")
    one = manyworld.make_flat_many_world_step(
        tst, FLAT_WORLDS, ts.comp_mask, num_steps=FLAT_STEPS)(
        manyworld.replicate_state(ts, FLAT_WORLDS),
        manyworld.replicate_input(InputFrame.zero("cpu"), FLAT_WORLDS))
    ref = convert.world_state_to_numpy(one)
    for r in runs["results"][d]:
        assert r["flat_local_worlds"] == FLAT_WORLDS // d
        for name, a in r["flat"].items():
            np.testing.assert_array_equal(a, ref[name], err_msg=name)


@pytest.mark.parametrize("d", DS)
def test_router_layouts_match_jax(d, runs):
    import jax

    from banggameengine_tpu.parallel import manyworld as jax_mw

    if len(jax.devices()) < d:
        pytest.skip(f"needs {d} devices")
    js, jst = _jax_boxes()
    mesh = jax_mw.make_world_mesh(jax.devices()[:d])
    want = [jax_mw.make_many_world_step(jst, mesh, js.comp_mask, w,
                                        verbose=False)[1]
            for w in (FLAT_WORLDS, 10)]
    for r in runs["results"][d]:
        assert r["layouts"] == want
    expected = {1: ["flat", "flat"], 2: ["flat-sharded", "flat-sharded"],
                4: ["flat-sharded", "vmapped"]}
    assert want == expected[d]


def test_router_falls_back_loudly(capsys):
    """The flat factory's ValueError is printed before the vmapped step is
    built (here on a stand-in mesh of 4, no process group needed)."""
    class FourRanks:
        def size(self):
            return 4

        def get_group(self):
            return None

    state_np, static_np = (_np(o) for o in _jax_boxes())
    ts = convert.world_state_from_numpy(state_np, "cpu")
    tst = convert.static_scene_from_numpy(static_np, "cpu")
    _, layout = manyworld.make_many_world_step(tst, FourRanks(),
                                               ts.comp_mask, 10)
    assert layout == "vmapped"
    assert "flat layout unavailable" in capsys.readouterr().out
    with pytest.raises(ValueError):
        manyworld.make_flat_many_world_step(tst, 10, ts.comp_mask,
                                            mesh=FourRanks())


@pytest.mark.parametrize("d", DS)
def test_entity_sharded_phase_matches_jax(d, runs):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from banggameengine_tpu.parallel.spatial import (
        make_entity_sharded_contact_phase)
    from banggameengine_tpu.scene.synthetic import build_falling_boxes

    if len(jax.devices()) < d:
        pytest.skip(f"needs {d} devices")
    _, jst = build_falling_boxes(24, seed=5, spread=4.0)
    p = runs["phase_in"]
    mesh = Mesh(np.asarray(jax.devices()[:d]), ("entity_shard",))
    jv, jw = jax.jit(make_entity_sharded_contact_phase(jst, mesh))(
        jnp.asarray(p["pos"]), jnp.asarray(p["quat"]), jnp.asarray(p["vel"]),
        jnp.asarray(p["ang"]), jnp.asarray(p["is_dyn"]),
        jnp.asarray(p["solid"]), jnp.float32(DT))
    for r in runs["results"][d]:
        v, w = r["phase"]
        np.testing.assert_allclose(v, np.asarray(jv), atol=PHASE_TOL,
                                   rtol=PHASE_TOL)
        np.testing.assert_allclose(w, np.asarray(jw), atol=PHASE_TOL,
                                   rtol=PHASE_TOL)
        assert float(np.abs(v).max()) > 0   # impulses applied


def test_modes_agree_across_mesh_sizes(runs):
    ref = runs["results"][1][0]
    for d in DS[1:]:
        got = runs["results"][d][0]
        for name, a in got["flat"].items():
            np.testing.assert_array_equal(a, ref["flat"][name], err_msg=name)
        for a, b in zip(got["phase"], ref["phase"]):
            np.testing.assert_array_equal(a, b)


def test_dryrun_multichip_on_four_ranks(runs):
    lines = runs["results"][4][0]["dryrun"]
    assert len(lines) == 5
    assert lines[0].startswith("8 worlds over 4 ranks OK")
    assert any(line.startswith("demo topology fully sharded OK")
               for line in lines)


@pytest.mark.parametrize("d", DS)
def test_flat_mesh_with_joints_bit_equal_to_single_device(d, runs):
    per_rank = ANT_WORLDS // d
    one = [_ant_flat(worlds=slice(r * per_rank, (r + 1) * per_rank))
           for r in range(d)]
    pos = np.concatenate([o[0] for o in one])
    impulse = np.concatenate([o[1] for o in one])
    for r in runs["results"][d]:
        np.testing.assert_array_equal(r["ant"][0], pos)
        np.testing.assert_array_equal(r["ant"][1], impulse)
