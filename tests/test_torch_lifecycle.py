"""The port's runtime lifecycle (``ecs/lifecycle.py``, ``BuiltScene.spawn``,
``despawn``, ``reparent``) against the JAX package on the CPU, on the
asset tree ``tests/data/app_assets`` built with room to spawn
(``capacity=16, max_trigger_slots=2``).

Bars: after every spawn, despawn and reparent the whole static scene and
state exactly equal to JAX's (the bit fields as uint32), the same ids,
names, logical ids and counts; the static tensors keep their storage and
shape while the level table fits, and the table grows as JAX's does when
the hierarchy outgrows it; ids recycle lowest-free-first, cycles and
self-parenting are refused, capacity and trigger-slot exhaustion raise.
The runtime scene's script (:func:`runtime_scene`: a crate spawned at
(3, 5, 3) and 300 hot-reloadable steps, then a trigger in its recycled
slot around the character, then a reparented child) against the JAX
golden ``tests/data/lifecycle_jax_golden.json``: the crate's track
within the golden's bar (1e-4; 0.0 measured on the CPU), at rest on the
ground box at y = 1.49, the ids and the trigger's Enter exact.
The submit path (``ecs/render_system.py``) on the same tree: the draw list
equal to JAX's, and a subset's frame within 1 level of JAX's on >= 99.9 %
of pixels.
``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_lifecycle.py``
rewrites the golden; ``test_lifecycle_golden_is_current`` runs the JAX
script again.  ``chip_smoke.py`` phase 18 holds the port to it on the
card.
"""

import dataclasses
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banggameengine_tpu.ecs import render_system as jax_render_system
from banggameengine_tpu.engine import (
    make_hot_reloadable_step_fn as jax_hot_step_fn,
)
from banggameengine_tpu.physics.config import (
    load_physics_config as jax_load_config,
)
from banggameengine_tpu.scene import ResourceManager as JaxResources
from banggameengine_tpu.scene import build_scene as jax_build_scene
from banggameengine_tpu.scene import parse_scene_json as jax_parse_scene
from banggameengine_tpu.state import InputFrame as JaxInput
from banggameengine_tpu_torch import convert
from banggameengine_tpu_torch.ecs import free_slots, is_alive
from banggameengine_tpu_torch.ecs import render_system
from banggameengine_tpu_torch.engine import make_hot_reloadable_step_fn
from banggameengine_tpu_torch.physics.config import load_physics_config
from banggameengine_tpu_torch.render.camera import Camera
from banggameengine_tpu_torch.scene.build import build_scene
from banggameengine_tpu_torch.scene.resources import ResourceManager
from banggameengine_tpu_torch.scene.schema import parse_scene_json
from banggameengine_tpu_torch.state import InputFrame
from test_torch_app_golden import ASSETS, DATA
from test_torch_app_golden import one_torch_thread  # noqa: F401
from test_torch_render_frame import frame_agreement

GOLDEN_JSON = os.path.join(DATA, "lifecycle_jax_golden.json")
SCENE = os.path.join(ASSETS, "scenes", "demo.json")
CONFIG = os.path.join(ASSETS, "config", "physics.json")
CAPACITY, TRIGGER_SLOTS = 16, 2
CRATE = dict(name="crate", pos=(3.0, 5.0, 3.0),
             collider={"shape": "box", "size": (0.5, 0.5, 0.5)},
             rigid_body={"type": "dynamic", "mass": 2.0})
STEPS, EVERY = 300, 10
# around the resting character (its capsule y 0.99 .. 4.89 at x 0, z -5),
# clear of the ground box's top at 0.99
ZONE = dict(name="zone", pos=(0.0, 2.5, -5.0),
            trigger={"shape": "box", "size": (1.0, 1.0, 1.0), "layer": 4})
ANCHOR = dict(name="anchor", pos=(4.0, 2.0, 0.0))
GADGET = dict(name="gadget", pos=(1.0, 0.0, 0.0))
ATOL, REST_Y = 1e-4, 1.49


def _builds(port: bool = True, jax: bool = True):
    """(JAX build, port build) of the asset tree with room to spawn."""
    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BANG_DISABLE_NATIVE", "1")
        mp.delenv("BANG_ASSETS_DIR", raising=False)
        if jax:
            out.append(jax_build_scene(
                jax_parse_scene(SCENE), JaxResources(ASSETS),
                jax_load_config(CONFIG), capacity=CAPACITY,
                max_trigger_slots=TRIGGER_SLOTS))
        if port:
            out.append(build_scene(
                parse_scene_json(SCENE), ResourceManager(ASSETS),
                load_physics_config(CONFIG), capacity=CAPACITY,
                max_trigger_slots=TRIGGER_SLOTS, device="cpu"))
    return out


def runtime_scene(built, step, zero, host) -> dict:
    """The runtime scene's script on either package: ``step(state, inp,
    static)``, ``zero`` its zero input, ``host(x)`` an array to numpy."""
    state = built.initial_state
    state, crate = built.spawn(state, **CRATE)
    track = []
    for k in range(1, STEPS + 1):
        state, _ = step(state, zero, built.static)
        if k % EVERY == 0:
            track.append(host(state.pos[crate]).tolist())
    cj = built.find_entity("cj")
    cj_pos = host(state.pos[cj]).tolist()
    state = built.despawn(state, crate)
    state, zone = built.spawn(state, **ZONE)
    slot = int(np.nonzero(host(built.static.trig_entity) == zone)[0][0])
    state, ev = step(state, zero, built.static)
    enter = np.nonzero(host(ev.trigger_enter[slot]))[0].tolist()
    state, anchor = built.spawn(state, **ANCHOR)
    state, gadget = built.spawn(state, **GADGET)
    built.reparent(state, gadget, "anchor")
    state, _ = step(state, zero, built.static)
    return dict(crate=crate, crate_track=track, cj=cj, cj_pos=cj_pos,
                zone=zone, zone_slot=slot, zone_enter=enter, anchor=anchor,
                gadget=gadget, gadget_world=host(state.world[gadget])[:3, 3]
                .tolist())


def _golden() -> dict:
    (jb,) = _builds(port=False)
    out = runtime_scene(jb, jax_hot_step_fn(), JaxInput.zero(), np.asarray)
    return dict(capacity=CAPACITY, trigger_slots=TRIGGER_SLOTS, crate_spawn=CRATE,
                zone_spawn=ZONE, anchor_spawn=ANCHOR, gadget_spawn=GADGET,
                steps=STEPS, every=EVERY, atol=ATOL, rest_y=REST_Y, **out)


def _jsonable(obj):
    return json.loads(json.dumps(obj))


def test_lifecycle_golden_is_current():
    with open(GOLDEN_JSON) as f:
        stored = json.load(f)
    assert _jsonable(_golden()) == stored, (
        "tests/data/lifecycle_jax_golden.json is stale: run PYTHONPATH=. "
        "JAX_PLATFORMS=cpu python tests/test_torch_lifecycle.py")


def test_runtime_scene_matches_jax_golden(one_torch_thread):  # noqa: F811
    with open(GOLDEN_JSON) as f:
        g = json.load(f)
    (tb,) = _builds(jax=False)
    got = runtime_scene(tb, make_hot_reloadable_step_fn(),
                        InputFrame.zero("cpu"), lambda t: t.numpy())
    err = np.abs(np.asarray(got["crate_track"])
                 - np.asarray(g["crate_track"])).max()
    assert err < g["atol"], f"|crate - JAX| = {err}"
    assert abs(got["crate_track"][-1][1] - g["rest_y"]) < 0.05
    for k in ("crate", "cj", "zone", "zone_slot", "zone_enter", "anchor",
              "gadget"):
        assert got[k] == g[k], k
    assert got["zone"] == got["crate"]          # the recycled slot
    assert got["zone_enter"] == [got["cj"]]
    np.testing.assert_allclose(got["cj_pos"], g["cj_pos"], atol=g["atol"])
    np.testing.assert_allclose(got["gadget_world"], [5.0, 2.0, 0.0],
                               atol=1e-5)


def _static_ids(static) -> dict:
    return {f.name: (getattr(static, f.name).data_ptr(),
                     tuple(getattr(static, f.name).shape))
            for f in dataclasses.fields(static)}


class _Pair:
    """The JAX and the port build side by side; every call runs on both
    and checks the results equal."""

    def __init__(self):
        self.jb, self.tb = _builds()
        self.js, self.ts = self.jb.initial_state, self.tb.initial_state
        self.check("build")

    def check(self, tag):
        ref = {f.name: np.asarray(getattr(self.jb.static, f.name))
               for f in dataclasses.fields(self.jb.static)}
        got = convert.static_scene_to_numpy(self.tb.static)
        for k, v in ref.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), (
                f"{tag}: static.{k}")
        got = convert.world_state_to_numpy(self.ts)
        for f in dataclasses.fields(self.js):
            v = np.asarray(getattr(self.js, f.name))
            assert np.array_equal(got[f.name], v), f"{tag}: state.{f.name}"
        for a in ("logical_ids", "entity_names", "counts"):
            assert getattr(self.tb, a) == getattr(self.jb, a), f"{tag}: {a}"

    def spawn(self, **kw):
        self.js, a = self.jb.spawn(self.js, **kw)
        self.ts, b = self.tb.spawn(self.ts, **kw)
        assert a == b
        self.check(f"spawn {kw}")
        return b

    def despawn(self, i):
        self.js = self.jb.despawn(self.js, i)
        self.ts = self.tb.despawn(self.ts, i)
        self.check(f"despawn {i}")

    def reparent(self, i, p):
        self.jb.reparent(self.js, i, p)
        self.tb.reparent(self.ts, i, p)
        self.check(f"reparent {i} {p}")


def test_static_and_state_match_jax_after_each_call():
    """Every kind of spawn (crate, trigger, capsule with its own layer and
    mask bits, euler rotation, parent by name), despawn (a child's parent,
    a trigger's owner, the character) and reparent (a cycle, a root, a
    new parent): all equal to JAX's, and no static tensor moves."""
    pair = _Pair()
    before = _static_ids(pair.tb.static)
    old_state = pair.ts
    crate = pair.spawn(**CRATE)
    assert old_state.alive[crate].item() is False   # the state is new
    zone = pair.spawn(**ZONE)
    pair.spawn(name="pill", pos=(1.0, 3.0, -2.0), euler=(0.1, 0.2, 0.3),
               velocity=(0.5, 0.0, 0.0),
               collider={"shape": "capsule", "size": (0.3, 0.6, 9.0)},
               rigid_body={"type": "dynamic", "mass": 1.5, "layer": 3,
                           "mask": 0xFFFF0000, "friction": 0.7})
    anchor = pair.spawn(**ANCHOR)
    gadget = pair.spawn(**GADGET, parent="anchor")
    pair.reparent(anchor, gadget)               # a cycle: refused
    pair.reparent(gadget, gadget)               # itself: refused
    pair.reparent(gadget, None)
    pair.reparent(gadget, "crate")
    pair.despawn(crate)                         # the gadget becomes a root
    assert int(pair.tb.static.parent[gadget]) == -1
    pair.despawn(zone)
    assert int(pair.tb.static.trig_entity[1]) == -1
    cj = pair.tb.find_entity("cj")
    pair.despawn(cj)
    assert int(pair.tb.static.char_entity[0]) == -1
    pair.despawn(cj)                            # not alive: unchanged
    assert pair.spawn(pos=(0.0, 3.0, 0.0)) == cj   # lowest free first
    assert _static_ids(pair.tb.static) == before


def test_level_table_grows_only_when_outgrown(caplog):
    """A chain under the character's hat fits the table's two spare rows,
    then outgrows it: the table grows as JAX's, with its log line."""
    pair = _Pair()
    before = _static_ids(pair.tb.static)
    rows = pair.tb.static.level_nodes.shape[0]
    parent = "cj_hat"
    for k in range(rows - 2):
        pair.spawn(name=f"link{k}", parent=parent)
        parent = f"link{k}"
    assert _static_ids(pair.tb.static) == before
    with caplog.at_level(logging.INFO, logger="Lifecycle"):
        pair.spawn(name="last", parent=parent)
    assert "outgrew the level table" in caplog.text
    after = _static_ids(pair.tb.static)
    assert after.pop("level_nodes")[1][0] == rows + 1
    before.pop("level_nodes")
    assert after == before


def test_recycling_refusals_and_exhaustion(caplog):
    pair = _Pair()
    a = pair.spawn(name="a")
    b = pair.spawn(name="b", parent="a")
    with caplog.at_level(logging.WARNING, logger="Lifecycle"):
        pair.reparent(a, b)
        pair.reparent(b, b)
    assert "cycle" in caplog.text and "self" in caplog.text
    assert int(pair.tb.static.parent[a]) == -1
    n_free = len(free_slots(pair.ts))
    pair.despawn(a)
    assert not is_alive(pair.ts, a) and len(free_slots(pair.ts)) == n_free + 1
    assert pair.spawn(name="c") == a
    pair.spawn(**ZONE)
    with pytest.raises(RuntimeError, match="trigger slots"):
        pair.tb.spawn(pair.ts, **ZONE)
    while len(free_slots(pair.ts)) > 0:
        pair.spawn(pos=(0.0, 50.0, 0.0))
    for b_, s in ((pair.jb, pair.js), (pair.tb, pair.ts)):
        with pytest.raises(RuntimeError, match="capacity"):
            b_.spawn(s, pos=(0.0, 60.0, 0.0))


def test_render_submissions_match_jax():
    """The draw list of the tree (the character's two MTL submeshes, the
    hat's override, the ground) equal to JAX's; the ground alone rendered
    through both packages' submit path at 128x32 (one tile)."""
    jb, tb = _builds()
    subs = render_system.gather_submissions(tb.render)
    ref = jax_render_system.gather_submissions(jb.render)
    assert [dataclasses.astuple(s) for s in subs] == [
        dataclasses.astuple(s) for s in ref]
    ground = [s for s in subs if s.entity == tb.find_entity("ground")]
    assert 0 < len(ground) < len(subs)
    cam = Camera()
    cam.position = np.array([0.0, 7.0, -10.0], np.float32)
    w, h = 128, 32
    view, proj = cam.view_matrix("cpu"), cam.proj_matrix(w / h, "cpu")
    pos = torch.as_tensor(cam.position)
    got = render_system.render_submissions(
        tb.render, ground, tb.initial_state.world, view, proj, pos, w, h,
        bin_capacity=2048).numpy()
    # jitted whole (the mask is a constant of the trace): eager, the JAX
    # frame takes ~25 s on the CPU, jitted ~3
    want = np.asarray(jax.jit(
        lambda rs, world, v, p, c: jax_render_system.render_submissions(
            rs, ground, world, v, p, c, w, h, bin_capacity=2048,
            raster_backend="walk"))(
        jb.render, jb.initial_state.world, jnp.asarray(view.numpy()),
        jnp.asarray(proj.numpy()), jnp.asarray(cam.position)))
    off, sky_off = frame_agreement(got, want)
    assert off <= 0.001 * w * h and sky_off == 0
    full = render_system.render_submissions(
        tb.render, subs, tb.initial_state.world, view, proj, pos, w, h,
        bin_capacity=2048).numpy()
    assert (got != full).any()        # the character is not in the subset


if __name__ == "__main__":
    os.environ["BANG_DISABLE_NATIVE"] = "1"
    os.environ.pop("BANG_ASSETS_DIR", None)
    golden = _golden()
    with open(GOLDEN_JSON, "w") as f:
        json.dump(golden, f)
        f.write("\n")
    print(f"wrote {GOLDEN_JSON}")
