"""IsaacGymEnvs' Ant on the port: the motors (``physics/joints.py``), the
jointed flat many-world step (``parallel/manyworld.py``) and the builder
(``scene/ant.py``), against the benchmark's configuration and its plain
reference (``portbench/reference/physics/articulated.py``: the motor
torque written from its equation, frames as matrices, the position pass
solved as 3x3 systems; its scene built from the configuration by
``portbench/harness/ant.py``, not by the port's builder).

- A hinge pair in free space under a constant command keeps its
  momentum: the motor's torques are equal and opposite.
- The flat step of 3 Ant worlds with seeded commands, each call against
  the reference stepping each world alone from the program's own state.
- The builder's masses, start angles and feet against the tables, and
  its scene, joint table and motors against the reference's own build.
- The position pass closes a gap and leaves the velocities; a motor set
  needs its command.
- The vmapped layout refuses joints.
"""

import copy
import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from banggameengine_tpu_torch import math3d
from banggameengine_tpu_torch.engine import make_multi_step_fn
from banggameengine_tpu_torch.parallel import manyworld as mw
from banggameengine_tpu_torch.physics import joints as jt
from banggameengine_tpu_torch.physics.solver import inv_inertia_world
from banggameengine_tpu_torch.scene import ant
from banggameengine_tpu_torch.state import InputFrame, tree_replace
from portbench.harness import ant as bench_ant
from portbench.reference import state as rs
from portbench.reference.physics import articulated
from test_torch_app_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

with open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "portbench", "configs",
        "isaacgym-ant4k.json")) as _f:
    CONFIG = json.load(_f)
INP = InputFrame.zero("cpu")


def _worlds(w, seed=7, **start):
    scene = copy.deepcopy(CONFIG["scene"])
    scene["start"].update(start)
    return ant.build_ant_worlds(scene, CONFIG["physics"], num_worlds=w,
                                seed=seed, device="cpu")


def _world(state, w):
    return rs.WorldState(**{f.name: getattr(state, f.name)[w].clone()
                            for f in dataclasses.fields(rs.WorldState)})


def test_hinge_pair_keeps_its_momentum():
    """A thigh and a shin on the ankle hinge, no gravity, no ground,
    driven by a constant command for 30 steps.  The motor's torques, the
    joint's damping and its rows are equal and opposite on the two bodies
    (each has one joint, so its split is 1): each step keeps the pair's
    linear momentum, and its angular momentum but for one term, the
    point rows' impulse P acting at anchors the last step's spin has
    moved apart: the change is (pB - pA) x P.  Both are taken at the pose
    the step's impulses act on (the integration after them keeps each
    body's spin, not its angular momentum, as it did before motors).
    The rest is rounding: 3.4e-6 of the momenta's size at most, held at
    1e-5."""
    aw = _worlds(1)
    keep = [1, 2]                         # thigh_1, shin_1
    st, s0 = aw.static, aw.state
    per_body = {"body_type", "shape_type", "shape_size", "inv_mass",
                "inv_inertia_body", "friction", "restitution", "layer",
                "mask", "parent"}
    static = dataclasses.replace(
        st, **{k: getattr(st, k)[keep] for k in per_body},
        level_nodes=torch.tensor([[0, 1]], dtype=torch.int32),
        gravity=torch.tensor(0.0),
        ground_enabled=torch.tensor(False))
    state = tree_replace(
        s0, **{f.name: getattr(s0, f.name)[0][keep]
               for f in dataclasses.fields(s0)
               if getattr(s0, f.name).dim() >= 2
               and f.name not in ("trigger_overlap", "trigger_active")},
        time=s0.time[0], step_idx=s0.step_idx[0],
        trigger_overlap=s0.trigger_overlap[0][:, keep],
        trigger_active=s0.trigger_active[0])
    tb = aw.tables
    joints = jt.make_joint_set(
        2, body_a=[0], body_b=[1], kind=tb["kind"][1:2],
        **{k: tb[k][1:2] for k in ("origin_a", "origin_b", "basis_a",
                                   "basis_b", "limit_lo", "limit_hi",
                                   "gear", "joint_damping")})
    run = make_multi_step_fn(static, 1, joints=joints, broadphase="dense")
    js = jt.make_joint_state(joints)
    mass = 1.0 / static.inv_mass.double()

    def momenta(pose, vel):
        i_w = torch.linalg.inv(inv_inertia_world(
            pose.quat, static.inv_inertia_body).double())
        spin = (i_w @ vel.ang_vel.double()[..., None])[..., 0]
        p = mass[:, None] * vel.lin_vel.double()
        orbit = torch.linalg.cross(pose.pos.double(), p)
        size = float(spin.abs().sum() + orbit.abs().sum())
        return p.sum(0), (spin + orbit).sum(0), size

    command = torch.tensor([0.7])
    spin = 0.0
    for _ in range(30):
        pre = dataclasses.replace(state)
        p0, l0, _ = momenta(pre, pre)
        state, js = run(state, INP, js, command)
        p, lvec, size = momenta(pre, state)
        anchor_a = pre.pos[0] + math3d.quat_rotate(pre.quat[0],
                                                   joints.origin_a[0])
        anchor_b = pre.pos[1] + math3d.quat_rotate(pre.quat[1],
                                                   joints.origin_b[0])
        moved = torch.linalg.cross((anchor_b - anchor_a).double(),
                                   js.impulse[0, :3].double())
        assert float((p - p0).abs().max()) < 1e-5 * size
        assert float((lvec - l0 - moved).abs().max()) < 1e-5 * size
        spin = max(spin, float((state.ang_vel[1] - state.ang_vel[0]).norm()))
    assert spin > 10.0       # the motor did turn the pair (rad/s)


@pytest.mark.parametrize("mass_splitting", [False, True])
def test_one_leg_keeps_its_linear_momentum(mass_splitting):
    """A torso, a thigh and a shin on their hip and ankle, no gravity, no
    ground, driven by a constant command for 10 steps: with mass splitting
    the joints' impulses are equal and opposite, so the three bodies'
    linear momentum stays to rounding (1.8e-7 of its scale, held at
    1e-5); without it the thigh, in two joints, takes half of each
    joint's impulse and its neighbours all of theirs, and the momentum
    moves by 4 % of its scale (held above 0.1 %)."""
    aw = _worlds(1, dof_pos_noise=0.0)
    keep = [0, 1, 2]                      # torso, thigh_1, shin_1
    st, s0 = aw.static, aw.state
    per_body = {"body_type", "shape_type", "shape_size", "inv_mass",
                "inv_inertia_body", "friction", "restitution", "layer",
                "mask", "parent"}
    static = dataclasses.replace(
        st, **{k: getattr(st, k)[keep] for k in per_body},
        level_nodes=torch.tensor([[0, 1, 2]], dtype=torch.int32),
        gravity=torch.tensor(0.0), ground_enabled=torch.tensor(False))
    state = tree_replace(
        s0, **{f.name: getattr(s0, f.name)[0][keep]
               for f in dataclasses.fields(s0)
               if getattr(s0, f.name).dim() >= 2
               and f.name not in ("trigger_overlap", "trigger_active")},
        time=s0.time[0], step_idx=s0.step_idx[0],
        trigger_overlap=s0.trigger_overlap[0][:, keep],
        trigger_active=s0.trigger_active[0])
    tb = aw.tables
    joints = jt.make_joint_set(
        3, body_a=[0, 1], body_b=[1, 2], kind=tb["kind"][:2],
        mass_splitting=mass_splitting,
        **{k: tb[k][:2] for k in ("origin_a", "origin_b", "basis_a",
                                  "basis_b", "limit_lo", "limit_hi",
                                  "gear", "joint_damping")})
    run = make_multi_step_fn(static, 10, joints=joints, broadphase="dense")
    mass = 1.0 / static.inv_mass.double()
    p0 = (mass[:, None] * state.lin_vel.double()).sum(0)
    state, _ = run(state, INP, jt.make_joint_state(joints),
                   torch.tensor([1.0, -1.0]))
    p = mass[:, None] * state.lin_vel.double()
    moved = float((p.sum(0) - p0).abs().max())
    scale = float(p.abs().sum())
    assert scale > 0.1                    # the motors did move the leg
    if mass_splitting:
        assert moved < 1e-5 * scale
    else:
        assert moved > 1e-3 * scale


def test_flat_ant_worlds_match_the_reference():
    """The flat step of 3 Ant worlds, 6 calls of 2 steps under seeded
    commands (N(0, 1) clipped to [-1, 1]), each call against the
    reference stepping each world alone from the program's state, joint
    impulses and command before it.  The two round differently (the
    port's frames are quaternions, the reference's matrices; the port
    gathers a body's torques and impulses, the reference adds them in
    joint order): a call from the same state reads 6e-8 to 4e-7 m, so
    1e-5 m and 1e-5 leave that twenty-fold.  The first call starts from
    ``reset_idx``'s clamp, which leaves ankles exactly on their bound,
    where the last bit of each side's angle decides whether a limit row
    is on: it reads up to 0.018 m and is held at 0.05 m."""
    aw = _worlds(3)
    step, layout = mw.make_many_world_step(
        aw.static, None, aw.state.comp_mask[0], 3, num_steps=2,
        joints=aw.joints, verbose=False)
    assert layout == "flat"
    ref = bench_ant.reference_scene(CONFIG, "cpu")
    state, js = aw.state, jt.make_joint_state(aw.joints, 3)
    g = torch.Generator().manual_seed(11)
    for call in range(6):
        command = torch.randn((3, 8), generator=g).clamp(-1.0, 1.0)
        pre = [(_world(state, w), js.impulse[w].clone()) for w in range(3)]
        state, js = step(state, INP, js, command)
        tol = 0.05 if call == 0 else 1e-5
        for w, (s0, imp) in enumerate(pre):
            want, want_imp = bench_ant.step(s0, *ref, imp, command[w], 2,
                                            10)
            assert int(state.step_idx[w]) == int(want.step_idx)
            np.testing.assert_allclose(state.pos[w], want.pos, rtol=0,
                                       atol=tol)
            dq = torch.minimum((state.quat[w] - want.quat).abs(),
                               (state.quat[w] + want.quat).abs())
            assert float(dq.max()) < tol
    assert bool(torch.isfinite(state.pos).all())


def test_builder_masses_angles_and_feet():
    """Masses from the geoms at density 5 as the tables read them (torso
    0.484 kg with its four welded capsules, thigh 0.0392, shin 0.0676,
    0.911 a world); each joint's angle in the built state, measured as
    the step measures it, is the angle drawn for it, within its range;
    with no noise every hip is at 0 and every ankle on the bound nearest
    0, its foot 0.5657 m x sin 30 degrees under the ankle, outwards."""
    aw = _worlds(2, seed=3)
    mass = 1.0 / aw.static.inv_mass.double()
    assert float(mass.sum()) == pytest.approx(0.911, abs=5e-4)
    assert float(mass[0]) == pytest.approx(0.484, abs=5e-4)
    assert mass[1::2].tolist() == pytest.approx([0.0392] * 4, abs=5e-5)
    assert mass[2::2].tolist() == pytest.approx([0.0676] * 4, abs=5e-5)

    def angles(state):
        j = aw.joints
        a, b = j.body_a.long(), j.body_b.long()
        fa = math3d.quat_to_mat3(math3d.quat_mul(state.quat[:, a],
                                                 j.frame_a))
        fb = math3d.quat_to_mat3(math3d.quat_mul(state.quat[:, b],
                                                 j.frame_b))
        return torch.atan2((fb[..., 0] * fa[..., 1]).sum(-1),
                           (fb[..., 0] * fa[..., 0]).sum(-1))

    body = ant.ant_body(CONFIG["scene"]["layout"])
    drawn = ant.start_poses(body, CONFIG["scene"]["start"], 2, 3,
                            "cpu")["angle"]
    np.testing.assert_allclose(angles(aw.state), drawn.float(), atol=1e-5)
    assert bool((drawn >= aw.joints.limit_lo - 1e-6).all()
                & (drawn <= aw.joints.limit_hi + 1e-6).all())

    rest = _worlds(1, dof_pos_noise=0.0, dof_vel_noise=0.0).state
    want = torch.tensor([0.0, 30.0] * 4)
    want[3::4] = -30.0                    # legs 2 and 3: -100..-30
    want[5] = -30.0
    want[7] = 30.0
    np.testing.assert_allclose(torch.rad2deg(angles(rest))[0], want,
                               atol=1e-4)
    shin = rest.pos[0, 2::2]
    tip = shin + math3d.quat_rotate(
        rest.quat[0, 2::2], torch.tensor([0.0, 0.5 * 0.4 * math.sqrt(2),
                                          0.0]).expand(4, 3))
    length = 0.4 * math.sqrt(2)
    torso_y = CONFIG["scene"]["start"]["torso_height"]
    np.testing.assert_allclose(tip[:, 1], torso_y - length * 0.5, atol=1e-5)
    legs = [v for k, v in CONFIG["scene"]["layout"]["legs"].items()
            if k != "columns"]
    for i, leg in enumerate(legs):
        out = np.asarray(leg[2][:2]) / np.linalg.norm(leg[2][:2])
        reach = 0.4 * math.sqrt(2) + length * math.cos(math.radians(30))
        # the port's (x, -z) is the source's (x, y)
        xy = np.array([float(tip[i, 0]), -float(tip[i, 2])])
        np.testing.assert_allclose(xy, reach * out, atol=1e-5)


def test_builder_matches_the_reference_build():
    """The builder's scene, joint table and motors against the
    reference's own build from the configuration (masses and inertias by
    slicing the geoms into disks, not the builder's closed forms): body
    ids, anchors, ranges, gears, damping and the position pass's sweeps
    alike; masses and inertias to 1e-6 of their size (the two sums round
    differently, 6e-8 of it in float32); frames to 1e-6 (the builder
    holds them as quaternions, 2.4e-7 apart)."""
    aw = _worlds(1)
    st, joints = aw.static, aw.joints
    ref, ref_joints, motors, sweeps = bench_ant.reference_scene(CONFIG,
                                                                "cpu")
    for name in ("inv_mass", "inv_inertia_body"):
        np.testing.assert_allclose(getattr(st, name), getattr(ref, name),
                                   rtol=1e-6, atol=0)
    for name in ("shape_type", "shape_size", "body_type", "friction",
                 "restitution", "gravity", "fixed_dt"):
        assert torch.equal(getattr(st, name), getattr(ref, name)), name
    for name in ("body_a", "body_b", "origin_a", "origin_b", "limit_lo",
                 "limit_hi"):
        assert torch.equal(getattr(joints, name),
                           getattr(ref_joints, name)), name
    for q, basis in ((joints.frame_a, ref_joints.basis_a),
                     (joints.frame_b, ref_joints.basis_b)):
        np.testing.assert_allclose(math3d.quat_to_mat3(q), basis, atol=1e-6)
    assert torch.equal(joints.gear, motors.gear)
    assert torch.equal(joints.joint_damping, motors.damping)
    assert joints.motored and joints.position_iterations == sweeps == 8


def test_position_pass_holds_the_anchors():
    """An Ant world at rest with each shin pulled 0.037 m off its ankle:
    the position pass's 8 sweeps (one step's) take every anchor gap to
    under a tenth of that (2.1 mm; the next steps take it further), and
    the reference's pass, from the same poses, lands within 1e-6 m of the
    program's (the two round differently); a set with no sweeps leaves
    the poses as they are."""
    aw = _worlds(1, dof_pos_noise=0.0, dof_vel_noise=0.0)
    st, joints = aw.static, aw.joints
    pos = aw.state.pos[0].clone()
    pos[2::2] += torch.tensor([0.03, -0.01, 0.02])
    quat = aw.state.quat[0]
    live = torch.ones(9, dtype=torch.bool)
    args = (live, live, st.inv_mass, st.inv_inertia_body)
    new_pos, new_quat = jt.project_joints(pos, quat, *args, joints)
    ref, ref_joints, _, sweeps = bench_ant.reference_scene(CONFIG, "cpu")
    census = bench_ant.census(
        tree_replace(aw.state, pos=new_pos[None], quat=new_quat[None]), 0,
        ref_joints, 0.31)
    before = bench_ant.census(tree_replace(aw.state, pos=pos[None]), 0,
                              ref_joints, 0.31)
    assert before["anchor_gap_m"][2] > 0.03
    assert census["anchor_gap_m"][2] < 0.1 * before["anchor_gap_m"][2]
    want = articulated.hold_joints(
        rs.WorldState(**{**{f.name: getattr(aw.state, f.name)[0]
                            for f in dataclasses.fields(rs.WorldState)},
                         "pos": pos}), ref, ref_joints, sweeps)
    np.testing.assert_allclose(new_pos, want.pos, rtol=0, atol=1e-6)
    still = dataclasses.replace(joints, position_iterations=0)
    same = jt.project_joints(pos, quat, *args, still)
    assert torch.equal(same[0], pos) and torch.equal(same[1], quat)


def test_a_motor_set_needs_its_command():
    """The set decides whether motors run: a set with motors stepped
    without a command, or a set without motors given one, raises."""
    aw = _worlds(2)
    step, _ = mw.make_many_world_step(
        aw.static, None, aw.state.comp_mask[0], 2, num_steps=1,
        joints=aw.joints, verbose=False)
    js = jt.make_joint_state(aw.joints, 2)
    with pytest.raises(ValueError, match="motor_command"):
        step(aw.state, INP, js)
    idle = dataclasses.replace(aw.joints, motored=False,
                               gear=torch.zeros(8),
                               joint_damping=torch.zeros(8))
    step, _ = mw.make_many_world_step(
        aw.static, None, aw.state.comp_mask[0], 2, num_steps=1,
        joints=idle, verbose=False)
    with pytest.raises(ValueError, match="motor_command"):
        step(aw.state, INP, js, torch.zeros(2, 8))


def test_vmapped_layout_refuses_joints():
    aw = _worlds(2)
    with pytest.raises(ValueError, match="flat layout"):
        mw.make_sharded_many_world_step(aw.static, joints=aw.joints)
