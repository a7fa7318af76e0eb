"""Joints and damping on the dense route (``physics/joints.py``), against
the benchmark's plain reference (``portbench/reference/physics/jointed.py``
and ``joints.py``: written from the joint equations, with frames as
matrices and the twist measured geometrically, not from the port's code),
and physical checks that catch an error both could share.

- Parity: two of Bullet's ragdolls (scale 3.5) and random chains of
  hinges and cone-twists at random poses and velocities, eagerly and
  through the captured step (:class:`RecordingGraph`), each state against
  the reference's free run from the same start.
- Physics: a ball-joint pendulum's period, a hinge's axes, limits pushed
  past, the jointed pairs' contacts, a ragdoll dropped and settled.
- Scenes without joints: no joint or damping op, no joint span, in the
  captured box and many-world steps; a route other than dense given
  joints raises.
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from banggameengine_tpu_torch import graphs, math3d
from banggameengine_tpu_torch.engine import make_multi_step_fn
from banggameengine_tpu_torch.parallel import manyworld as mw
from banggameengine_tpu_torch.physics import joints as jt
from banggameengine_tpu_torch.physics import solver as sv
from banggameengine_tpu_torch.physics import step as step_mod
from banggameengine_tpu_torch.physics.step import physics_step
from banggameengine_tpu_torch.scene import ragdolls as rd
from banggameengine_tpu_torch.scene.synthetic import build_falling_boxes
from banggameengine_tpu_torch.state import (
    BODY_DYNAMIC,
    BODY_STATIC,
    COMP_COLLIDER,
    COMP_RIGID_BODY,
    COMP_TRANSFORM,
    InputFrame,
    make_world_state,
    tree_replace,
)
from portbench.harness import ragdolls as bench_ragdolls
from portbench.harness import refsteps
from portbench.reference import state as rs
from portbench.reference.physics import jointed
from portbench.reference.physics import joints as jr
from test_torch_app_golden import one_torch_thread  # noqa: F401
from test_torch_graphs_sharded import RecordingGraph

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# The port and the reference round differently (the port's frames are
# quaternions, the reference's matrices; the twist is a quaternion split
# against a geometric angle; the reference solves each joint's rows with
# an LU solve, the port with an inverse): 20 free-running steps of two
# ragdolls read 1e-6 to 5e-6 m and 1e-6 in the quaternions, the chains
# 5e-6.  1e-4 leaves that twentyfold, and the reference in bfloat16 (its
# state rounded each step) reads 2e-2 or more, which the ragdoll test
# checks fails it.
POS_TOL = 1e-4
QUAT_TOL = 1e-4
INP = InputFrame.zero("cpu")
with open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "portbench", "configs",
        "bullet-ragdolls136.json")) as _f:
    _CONFIG = json.load(_f)
# Bullet's RagDoll as the benchmark's configuration writes it, unjittered
RAGDOLL = dict(_CONFIG["scene"], jitter_m=0.0, jitter_yaw_deg=0.0)
PHYSICS = _CONFIG["physics"]
PARTS = len(RAGDOLL["parts"]) - 1          # less the "columns" entry


def _ref(obj, cls):
    return cls(**{f.name: getattr(obj, f.name).clone()
                  for f in dataclasses.fields(cls)})


def _ref_joints(tables: dict, n: int) -> jr.Joints:
    return jr.Joints(**{k: torch.as_tensor(np.asarray(v), dtype=dtype)
                        for k, v, dtype in (
        ("body_a", tables["body_a"], torch.int32),
        ("body_b", tables["body_b"], torch.int32),
        ("kind", tables["kind"], torch.int8),
        ("origin_a", tables["origin_a"], torch.float32),
        ("origin_b", tables["origin_b"], torch.float32),
        ("basis_a", tables["basis_a"], torch.float32),
        ("basis_b", tables["basis_b"], torch.float32),
        ("limit_lo", tables["limit_lo"], torch.float32),
        ("limit_hi", tables["limit_hi"], torch.float32),
        ("lin_damping", tables.get("lin_damping", np.zeros(n)),
         torch.float32),
        ("ang_damping", tables.get("ang_damping", np.zeros(n)),
         torch.float32))})


def _ragdoll_joints(n_rag: int) -> jr.Joints:
    """The reference's joint table of the first ``n_rag`` ragdolls, as the
    benchmark builds it from the configuration's tables
    (``harness/ragdolls.py``, independent of the port's builder)."""
    _, _, raw = bench_ragdolls.ragdoll_pyramid(
        dict(RAGDOLL, size=n_rag), PHYSICS, 0, "cpu")
    joints = bench_ragdolls.joints_of(raw)
    j, n = n_rag * (len(RAGDOLL["joints"]) - 1), n_rag * PARTS
    return jr.Joints(**{
        f.name: getattr(joints, f.name)[:n if "damping" in f.name else j]
        for f in dataclasses.fields(jr.Joints)})


def _scene(size, inv_mass, inv_inertia, pos, quat, body_type=None,
           collider=None):
    """A scene of capsules (``size`` [N, 3]: radius, half height) from the
    ragdoll scene's slots and scalars; ``collider`` False leaves a body
    out of the contacts."""
    n = len(size)
    template = rd.build_ragdoll_pyramid(dict(RAGDOLL, size=1),
                                        device="cpu").static
    body_type = np.full(n, BODY_DYNAMIC) if body_type is None else body_type
    collider = np.ones(n, bool) if collider is None else collider

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype)

    static = dataclasses.replace(
        template, parent=t(np.full(n, -1), torch.int32),
        level_nodes=t(np.arange(n)[None], torch.int32),
        body_type=t(body_type, torch.int8),
        shape_type=t(np.full(n, 2), torch.int8),
        shape_size=t(size, torch.float32), inv_mass=t(inv_mass, torch.float32),
        inv_inertia_body=t(inv_inertia, torch.float32),
        friction=t(np.full(n, 0.5), torch.float32),
        restitution=t(np.zeros(n), torch.float32),
        layer=t(np.ones(n), torch.int32), mask=t(np.full(n, -1), torch.int32))
    comp = np.where(collider, COMP_TRANSFORM | COMP_COLLIDER | COMP_RIGID_BODY,
                    COMP_TRANSFORM | COMP_RIGID_BODY)
    state = tree_replace(make_world_state(n, 1, device="cpu"),
                         alive=torch.ones(n, dtype=torch.bool),
                         comp_mask=t(comp, torch.int32),
                         pos=t(pos, torch.float32),
                         quat=t(quat, torch.float32))
    return static, state


def _port_run(static, state, joints, steps, captured=False, every=False):
    """``steps`` steps of the port's captured-or-eager one-step program;
    the final (state, joint state), or every state with ``every``."""
    program = make_multi_step_fn(static, 1, joints=joints,
                                 broadphase="dense", max_neighbors=8)
    js = jt.make_joint_state(joints)
    states = []
    old = graphs.cpu_graph_class
    graphs.cpu_graph_class = RecordingGraph if captured else None
    try:
        for _ in range(steps):
            state, js = program(state, INP, js)
            if every:
                states.append(graphs.owned(state))
    finally:
        graphs.cpu_graph_class = old
    return (states if every else graphs.owned(state)), graphs.owned(js)


def _ref_run(static, state, joints, steps):
    rstatic, rstate = _ref(static, rs.StaticScene), _ref(state, rs.WorldState)
    imp = torch.zeros((joints.body_a.shape[0], jr.ROWS))
    for _ in range(steps):
        rstate, imp, limits = jointed.engine_step(rstate, rstatic, joints,
                                                  imp)
    return rstate, imp, limits


def _gaps(a, b):
    dq = torch.minimum((a.quat - b.quat).abs().amax(-1),
                       (a.quat + b.quat).abs().amax(-1))
    return (float((a.pos - b.pos).abs().max()), float(dq.max()))


def _random_velocities(state, seed, lin=1.0, ang=1.0):
    g = torch.Generator().manual_seed(seed)
    n = state.capacity
    return tree_replace(
        state, lin_vel=(torch.rand((n, 3), generator=g) * 2 - 1) * lin,
        ang_vel=(torch.rand((n, 3), generator=g) * 2 - 1) * ang)


def _tilted(state, seed, angle=0.05):
    """Each body turned by up to ``angle`` about a random axis: the
    ragdoll's rest pose puts the hips on their swing bound and the knees
    and elbows on their lower bound, exactly, where one rounding of the
    angle decides whether a limit row is on; tilted, no joint starts
    there."""
    g = torch.Generator().manual_seed(seed + 1)
    n = state.capacity
    turn = math3d.quat_from_axis_angle(
        torch.randn((n, 3), generator=g),
        (torch.rand(n, generator=g) * 2 - 1) * angle)
    return tree_replace(state, quat=math3d.quat_mul(turn, state.quat))


@pytest.mark.parametrize("pose", ["tilted", "exact"])
@pytest.mark.parametrize("captured", [False, True],
                         ids=["eager", "captured"])
def test_two_ragdolls_match_the_reference(captured, pose):
    """Two ragdolls of the pyramid's first row (scale 3.5), 20 steps: the
    joints snap together, the legs reach the ground, limits engage.
    ``tilted``: a seed's jitter, every part tilted and random velocities.
    ``exact``: the source's pose as built, at rest, its knees, elbows and
    hips on a bound; there each part's orientation is the identity or a
    quarter turn about z, which both sides' frames round alike, so both
    take the same rows and read 2.4e-6 m and 7.6e-7 (POS_TOL holds it).
    A seed's turn of the ragdolls (the benchmark's start) leaves those
    angles within a rounding of their bounds instead, where the rows
    follow the last bit (:func:`test_seeded_start_follows_the_last_bit`)."""
    if pose == "exact":
        sc = rd.build_ragdoll_pyramid(dict(RAGDOLL, size=2), count=2,
                                      device="cpu")
        state = sc.state
    else:
        sc = rd.build_ragdoll_pyramid(
            dict(RAGDOLL, size=2, jitter_m=0.005, jitter_yaw_deg=0.5),
            seed=5, count=2, device="cpu")
        state = _tilted(_random_velocities(sc.state, 5), 5)
    got, js = _port_run(sc.static, state, sc.joints, 20, captured)
    ref_joints = _ragdoll_joints(2)
    want, imp, limits = _ref_run(sc.static, state, ref_joints, 20)
    pos_gap, quat_gap = _gaps(got, want)
    assert pos_gap < POS_TOL and quat_gap < QUAT_TOL, (pos_gap, quat_gap)
    assert int(got.step_idx) == int(want.step_idx) == 20
    assert int(js.limit_rows) == int(limits) > 0
    if not captured:
        # the bfloat16 control fails the tolerance
        ctrl, _, _ = bench_ragdolls.step(
            _ref(state, rs.WorldState), _ref(sc.static, rs.StaticScene),
            ref_joints, torch.zeros_like(imp), 20, 10, 8, mode="control")
        assert max(_gaps(ctrl, want)) > 10 * POS_TOL


def test_seeded_start_follows_the_last_bit():
    """The benchmark's start witness: two ragdolls of a seed's pose at rest
    (each turned about y by the jitter, so their knees, elbows and hips
    sit within a rounding of a bound).  The reference from positions one
    float32 step away stays within POS_TOL over 20 steps; from
    orientations one float32 step away too (``harness.ragdolls.nudged``,
    the cell's ``rounding`` reading) a limit row turns on or off in the
    first steps and the parts part by millimetres (3.5e-3 m measured), as
    the program's start does on the card."""
    sc = rd.build_ragdoll_pyramid(
        dict(RAGDOLL, size=2, jitter_m=0.005, jitter_yaw_deg=0.5), seed=5,
        count=2, device="cpu")
    ref_joints = _ragdoll_joints(2)
    static = _ref(sc.static, rs.StaticScene)
    imp = torch.zeros((sc.joints.num_joints, jr.ROWS))

    def run(state):
        return bench_ragdolls.step(state, static, ref_joints, imp, 20, 10,
                                   8)[0]

    start = _ref(sc.state, rs.WorldState)
    want = run(start)
    assert max(_gaps(run(refsteps.nudged(start)), want)) < POS_TOL
    assert _gaps(run(bench_ragdolls.nudged(start)), want)[0] > 1e-3


def _random_chain(seed: int, links: int = 6):
    """A chain of capsules joined by random hinges and cone-twists at
    random frames, anchors, limits, poses and velocities."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.1, 0.2, links)
    hh = rng.uniform(0.2, 0.4, links)
    size = np.stack([r, hh, np.zeros(links)], -1)
    e = 2.0 * np.stack([r, r + hh, r], -1)
    inertia = 1.0 / (1.0 / 12.0 * np.stack([e[:, 1] ** 2 + e[:, 2] ** 2,
                                            e[:, 0] ** 2 + e[:, 2] ** 2,
                                            e[:, 0] ** 2 + e[:, 1] ** 2], -1))
    pos = np.stack([np.arange(links) * 0.9, np.full(links, 3.0),
                    np.zeros(links)], -1) + rng.uniform(-0.1, 0.1,
                                                        (links, 3))
    quat = rng.normal(size=(links, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)

    def rot():
        q = torch.as_tensor(rng.normal(size=4), dtype=torch.float32)
        return math3d.quat_to_mat3(q / q.norm()).numpy()

    j = links - 1
    kind = rng.integers(0, 2, j)
    tables = dict(
        body_a=np.arange(j), body_b=np.arange(1, links), kind=kind,
        origin_a=rng.uniform(-0.3, 0.3, (j, 3)),
        origin_b=rng.uniform(-0.3, 0.3, (j, 3)),
        basis_a=np.stack([rot() for _ in range(j)]),
        basis_b=np.stack([rot() for _ in range(j)]),
        limit_lo=np.where(kind == jt.HINGE, rng.uniform(-1.0, 0.0, j),
                          rng.uniform(0.3, 1.2, j)),
        limit_hi=np.where(kind == jt.HINGE, rng.uniform(0.0, 1.0, j),
                          rng.uniform(0.0, 0.8, j)),
        lin_damping=rng.uniform(0.0, 0.2, links),
        ang_damping=rng.uniform(0.0, 0.9, links))
    static, state = _scene(size, np.ones(links), inertia, pos, quat)
    return static, _random_velocities(state, seed, 2.0, 3.0), tables


@pytest.mark.parametrize("seed,captured", [(1, False), (2, True)],
                         ids=["eager", "captured"])
def test_random_chain_matches_the_reference(seed, captured):
    """A chain of 6 capsules, its 5 joints random hinges and cone-twists
    far from their rest (point, axis and limit rows all active), 12
    steps."""
    static, state, tables = _random_chain(seed)
    joints = jt.make_joint_set(static.capacity, **tables, device="cpu")
    got, js = _port_run(static, state, joints, 12, captured)
    want, _, limits = _ref_run(static, state,
                               _ref_joints(tables, static.capacity), 12)
    pos_gap, quat_gap = _gaps(got, want)
    assert pos_gap < POS_TOL and quat_gap < QUAT_TOL, (pos_gap, quat_gap)
    assert int(js.limit_rows) == int(limits)


def _frames(state, joints: jr.Joints):
    """The joints' world frames and anchor gaps at ``state``, measured as
    the reference measures them."""
    a, b = joints.body_a.long(), joints.body_b.long()
    ra = math3d.quat_to_mat3(state.quat[a])
    rb = math3d.quat_to_mat3(state.quat[b])
    fa = (ra[..., :, :, None] * joints.basis_a[..., None, :, :]).sum(-2)
    fb = (rb[..., :, :, None] * joints.basis_b[..., None, :, :]).sum(-2)
    pa = state.pos[a] + (ra * joints.origin_a[:, None]).sum(-1)
    pb = state.pos[b] + (rb * joints.origin_b[:, None]).sum(-1)
    return fa, fb, (pb - pa).norm(dim=-1)


def _angles(fa, fb):
    """(hinge angle, swing, twist) of each joint."""
    theta = torch.atan2((fb[..., 0] * fa[..., 1]).sum(-1),
                        (fb[..., 0] * fa[..., 0]).sum(-1))
    phi = torch.acos((fa[..., 0] * fb[..., 0]).sum(-1).clamp(-1.0, 1.0))
    psi, _ = jr.twist(fa, fb)
    return theta, phi, psi


def _pair(kind, lo, hi, basis_a=np.eye(3), basis_b=np.eye(3), tilt=0.0,
          ang=(0.0, 0.0, 0.0), gravity=True):
    """A fixed capsule and a dynamic one hanging from it by a joint at the
    fixed one's foot, with no contacts: the dynamic one turned by ``tilt``
    about z around the joint and spun at ``ang``, damped as a ragdoll's
    parts are (0.05, 0.85)."""
    size = np.array([[0.1, 0.2, 0.0], [0.1, 0.3, 0.0]])
    pivot = np.array([0.0, 4.9, 0.0])
    anchor_b = np.array([0.0, 0.3, 0.0])
    turn = rd.euler_zyx((0.0, 0.0, tilt))
    q = math3d.quat_from_axis_angle(torch.tensor([0.0, 0.0, 1.0]),
                                    torch.tensor(tilt))
    static, state = _scene(
        size, [0.0, 1.0], [[0.0] * 3, [8.0, 20.0, 8.0]],
        [[0.0, 5.0, 0.0], pivot - turn @ anchor_b],
        [[0, 0, 0, 1], q.tolist()],
        body_type=np.array([BODY_STATIC, BODY_DYNAMIC]),
        collider=np.array([False, False]))
    if not gravity:
        static = dataclasses.replace(static, gravity=torch.tensor(0.0))
    state = tree_replace(state, ang_vel=torch.tensor([[0.0] * 3, ang]))
    tables = dict(body_a=[0], body_b=[1], kind=[kind],
                  origin_a=[[0.0, -0.1, 0.0]], origin_b=[anchor_b],
                  basis_a=[basis_a], basis_b=[basis_b], limit_lo=[lo],
                  limit_hi=[hi], lin_damping=[0.0, 0.05],
                  ang_damping=[0.0, 0.85])
    return static, state, tables


def test_ball_joint_pendulum_period():
    """A point mass on a massless rod of 0.15 m from a fixed pivot (a
    cone-twist whose spans are never reached), swung 5 degrees: its
    period is 2 pi sqrt(L / g) within 2 %."""
    length, amp = 0.15, math.radians(5.0)
    bob = [length * math.sin(amp), 5.0 - length * math.cos(amp), 0.0]
    static, state = _scene(
        np.array([[0.02, 0.0, 0.0], [0.02, 0.0, 0.0]]), [0.0, 1.0],
        [[0.0] * 3, [1.0 / 1.6e-4] * 3], [[0.0, 5.0, 0.0], bob],
        [[0, 0, 0, 1], [0, 0, 0, 1]],
        body_type=np.array([BODY_STATIC, BODY_DYNAMIC]),
        collider=np.array([False, False]))
    tables = dict(body_a=[0], body_b=[1], kind=[jt.CONE_TWIST],
                  origin_a=[[0.0, 0.0, 0.0]],
                  origin_b=[[-bob[0], 5.0 - bob[1], 0.0]],
                  basis_a=[np.eye(3)], basis_b=[np.eye(3)],
                  limit_lo=[math.pi], limit_hi=[math.pi])
    joints = jt.make_joint_set(2, **tables, device="cpu")
    states, _ = _port_run(static, state, joints, 240, every=True)
    x = np.array([float(s.pos[1, 0]) for s in states])
    dt = float(static.fixed_dt)
    # times of the downward zero crossings, linearly interpolated
    k = np.nonzero((x[:-1] > 0) & (x[1:] <= 0))[0]
    t = (k + x[k] / (x[k] - x[k + 1]) + 1) * dt
    period = float(np.diff(t).mean())
    want = 2 * math.pi * math.sqrt(length / -float(static.gravity))
    assert len(t) >= 3
    assert abs(period / want - 1.0) < 0.02, (period, want)


def test_hinge_keeps_its_axes_aligned():
    """A body spun about all three axes on a hinge to a fixed one, with
    no gravity, keeps the hinge axes within 0.01 rad of each other."""
    static, state, tables = _pair(jt.HINGE, -4.0, 4.0, ang=(3.0, 2.0, -4.0),
                                  gravity=False)
    joints = jt.make_joint_set(2, **tables, device="cpu")
    states, _ = _port_run(static, state, joints, 90, every=True)
    ref = _ref_joints(tables, 2)
    worst = 0.0
    for s in states[10:]:
        fa, fb, _ = _frames(s, ref)
        cos = (fa[..., 2] * fb[..., 2]).sum(-1).clamp(-1.0, 1.0)
        worst = max(worst, float(torch.acos(cos).max()))
    assert worst < 0.01, worst


@pytest.mark.parametrize("kind", ["hinge", "cone_twist"])
def test_limit_driven_past_holds(kind):
    """A hinge (axis z, limits [0.2, 0.6]) started at 0.4 and spun past
    its upper bound, then pulled by gravity past its lower one; a
    cone-twist (span pi/6) whose rest hangs 0.8 rad off its axis, twisted
    past its twist span (0.2).  Neither goes more than 0.1 rad past a
    bound once it is reached, and gravity's pull ends within 0.1 rad of
    the bound it holds against."""
    if kind == "hinge":
        static, state, tables = _pair(jt.HINGE, 0.2, 0.6, tilt=0.4,
                                      ang=(0.0, 0.0, 6.0))
    else:
        static, state, tables = _pair(
            jt.CONE_TWIST, math.pi / 6, 0.2,
            basis_a=rd.euler_zyx((0.0, 0.0, math.pi / 2 + 0.8)),
            basis_b=rd.euler_zyx((0.0, 0.0, math.pi / 2)), tilt=0.8,
            ang=(-4.0 * math.sin(0.8), 4.0 * math.cos(0.8), 0.0))
    joints = jt.make_joint_set(2, **tables, device="cpu")
    states, _ = _port_run(static, state, joints, 150, every=True)
    ref = _ref_joints(tables, 2)
    theta, phi, psi = (np.array([float(x) for x in v]) for v in zip(
        *(_angles(*_frames(s, ref)[:2]) for s in states)))
    if kind == "hinge":
        assert theta.max() > 0.6 and theta.max() < 0.6 + 0.1
        assert theta.min() > 0.2 - 0.1 and theta[:20].max() > 0.6
        assert abs(theta[-1] - 0.2) < 0.1
    else:
        assert phi.max() > math.pi / 6 and phi.max() < math.pi / 6 + 0.1
        assert abs(phi[-1] - math.pi / 6) < 0.1
        assert psi.max() > 0.2 and psi.max() < 0.2 + 0.1


def _partners(state):
    """Each body's cached contact partners after a step (-1 the ground)."""
    feat = state.contact_feat
    return torch.where(feat >= 0, torch.div(feat, 64, rounding_mode="floor")
                       - 1, -2)


def test_jointed_pairs_have_no_contacts_and_touching_parts_do():
    """One ragdoll posed with its left lower arm across the pelvis: the
    jointed pairs, which overlap at every joint, leave no contact; the
    arm and the pelvis, not jointed, touch and make one."""
    sc = rd.build_ragdoll_pyramid(dict(RAGDOLL, size=1), device="cpu")
    pos = sc.state.pos.clone()
    pelvis, arm = 0, 8
    pos[arm] = pos[pelvis] + torch.tensor([0.0, 0.0, 0.6])
    state = tree_replace(sc.state, pos=pos)
    out, _ = _port_run(sc.static, state, sc.joints, 1)
    partners = _partners(out)
    a, b = sc.joints.body_a.long(), sc.joints.body_b.long()
    for i, j in zip(a.tolist(), b.tolist()):
        assert not (partners[i] == j).any() and not (partners[j] == i).any()
    assert (partners[arm] == pelvis).any() and (partners[pelvis] == arm).any()
    # the same scene without the jointed pairs' filter would list them
    nl, _ = step_mod._neighbor_lists(
        sc.static, state.pos, state.quat, state.alive,
        state.alive, "dense", 8, 2.5, 4096, 8)
    assert (nl.idx[0] == 1).any()


def test_dropped_ragdoll_settles_within_its_joints():
    """One ragdoll dropped from 2 m and settled for 3 s: every anchor gap
    under 0.1 m (3 % of the 3.5 m scale), every angle within its limit
    plus 0.1 rad."""
    sc = rd.build_ragdoll_pyramid(dict(RAGDOLL, size=1), device="cpu")
    state = tree_replace(sc.state, pos=sc.state.pos
                         + torch.tensor([0.0, 2.0, 0.0]))
    out, _ = _port_run(sc.static, state, sc.joints, 360)
    ref = _ragdoll_joints(1)
    fa, fb, gap = _frames(out, ref)
    theta, phi, psi = _angles(fa, fb)
    hinge = ref.kind == jr.HINGE
    lo, hi = ref.limit_lo, ref.limit_hi
    assert float(gap.max()) < 0.1
    assert bool(((theta >= lo - 0.1) & (theta <= hi + 0.1))[hinge].all())
    assert bool((phi <= lo + 0.1)[~hinge].all())
    assert bool((psi <= hi + 0.1)[~hinge].all())


@pytest.fixture
def no_joint_code(monkeypatch, request):
    """Every joint, damping and motor function raises (in the ragdolls'
    steps, which have joints but no motor, the motors' alone), and the
    spans entered are recorded."""
    def refuse(*_a, **_k):
        raise AssertionError("joint code ran in a scene without joints")

    names = ("joint_rows", "apply_damping", "jointed_pairs", "apply_motors")
    if request.node.callspec.params.get("scene") == "ragdolls":
        names = ("apply_motors",)
    for name in names:
        monkeypatch.setattr(jt, name, refuse)
    entered = []
    for mod in (step_mod, sv):
        real = mod.span

        def recording(name, device=None, real=real):
            entered.append(name)
            return real(name, device)
        monkeypatch.setattr(mod, "span", recording)
    monkeypatch.setattr(graphs, "cpu_graph_class", RecordingGraph)
    return entered


@pytest.mark.parametrize("scene", ["boxes_dense", "boxes_allpairs",
                                   "flat_worlds", "ragdolls"])
def test_scenes_without_joints_capture_no_joint_op(no_joint_code, scene):
    """The captured steps of a box world (dense and all-pairs routes) and
    of the flat many-world step hold no joint, damping or motor op and
    neither a ``physics.joints`` nor a ``physics.motors`` span; the
    ragdolls' steps, whose joints have no motor, hold no motor op and no
    ``physics.motors`` span."""
    state, static = build_falling_boxes(8, seed=4, with_character=True,
                                        with_trigger=True, device="cpu")
    if scene == "ragdolls":
        sc = rd.build_ragdoll_pyramid(dict(RAGDOLL, size=1), device="cpu")
        fn = make_multi_step_fn(sc.static, 2, joints=sc.joints,
                                broadphase="dense", max_neighbors=8)
        fn(sc.state, INP, jt.make_joint_state(sc.joints))
        assert "physics.joints" in no_joint_code
        assert "physics.motors" not in no_joint_code
        return
    if scene == "flat_worlds":
        fn = mw.make_flat_many_world_step(static, 2, state.comp_mask,
                                          num_steps=2)
        fn(mw.replicate_state(state, 2), InputFrame.zero("cpu"))
    else:
        route = scene.split("_")[1]
        state, static = build_falling_boxes(8, seed=4, device="cpu")
        fn = make_multi_step_fn(static, 2, broadphase=route,
                                max_neighbors=8)
        fn(state, InputFrame.zero("cpu"))
    assert no_joint_code and "physics.joints" not in no_joint_code
    assert "physics.motors" not in no_joint_code
    assert "physics.solver" in no_joint_code


@pytest.mark.parametrize("route", ["grid", "allpairs"])
def test_joints_on_another_route_raise(route):
    sc = rd.build_ragdoll_pyramid(dict(RAGDOLL, size=1), device="cpu")
    with pytest.raises(ValueError, match="dense"):
        physics_step(sc.state, INP, sc.static, broadphase=route,
                     joints=sc.joints,
                     joint_state=jt.make_joint_state(sc.joints))


def test_static_route_runs_joints():
    """The static route takes joints: over lists that hold every pair of
    distinct parts but the jointed ones (as the flat many-world factory
    builds them), one ragdoll's 5 steps equal the dense route's to the
    last bit: both lists hold the touching partners in id order, so the
    narrowphase, the compaction and the unified solve see the same
    contacts."""
    sc = rd.build_ragdoll_pyramid(dict(RAGDOLL, size=1), device="cpu")
    n = sc.static.capacity
    jointed = jt.jointed_pairs(sc.joints, n) | torch.eye(n, dtype=torch.bool)
    k = int((~jointed).sum(dim=1).max())
    order = torch.argsort(jointed.to(torch.int8), dim=1, stable=True)[:, :k]
    valid = ~torch.gather(jointed, 1, order)
    lists = (order.to(torch.int32), valid)
    dense = make_multi_step_fn(sc.static, 5, joints=sc.joints,
                               broadphase="dense", max_neighbors=k)
    static = make_multi_step_fn(sc.static, 5, joints=sc.joints,
                                broadphase="static", static_neighbors=lists)
    js = jt.make_joint_state(sc.joints)
    a, ja = dense(sc.state, INP, js)
    b, jb = static(sc.state, INP, js)
    assert torch.equal(a.pos, b.pos) and torch.equal(a.quat, b.quat)
    assert torch.equal(ja.impulse, jb.impulse)
