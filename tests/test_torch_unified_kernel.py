"""The unified solve's route and the checks of its CUDA kernel's wrapper, on
the CPU: CPU tensors take the plain version
(``unified_kernel.solve_unified_reference``: the feature match,
``joints.joint_rows`` and ``solver.solve_contacts_unified``) and launch
nothing, and ``unified_kernel.check_inputs`` refuses what the kernels do
not take.  The kernels themselves run only on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import json
import os

import numpy as np
import pytest
import torch

from banggameengine_tpu_torch import kernel_cases
from banggameengine_tpu_torch.engine import make_multi_step_fn
from banggameengine_tpu_torch.physics import joints as jt
from banggameengine_tpu_torch.physics import solver as sv
from banggameengine_tpu_torch.physics import unified_kernel as uk
from banggameengine_tpu_torch.scene.ragdolls import build_ragdoll_pyramid
from banggameengine_tpu_torch.scene.synthetic import build_falling_boxes
from banggameengine_tpu_torch.state import InputFrame

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "portbench", "configs",
                       "bullet-ragdolls136.json")) as f:
    RAGDOLL = dict(json.load(f)["scene"], size=1)      # one ragdoll


def _case(n=9, c=12, joints=0, seed=3, mass_splitting=False):
    return kernel_cases.unified_solve_tensors(
        kernel_cases.unified_solve_case(n, c, seed, joints=joints), "cpu",
        mass_splitting)


def _leaves(out):
    v, w, lams, *rest = out
    leaves = [v, w, *lams]
    if rest:
        leaves += [rest[0].impulse, rest[0].limit_rows]
    return leaves


def _assert_bits_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)


@pytest.mark.parametrize("joints,mass_splitting",
                         [(0, False), (14, False), (14, True)])
def test_cpu_tensors_take_the_plain_version(joints, mass_splitting):
    """CPU tensors take the plain twin: the wrapper refuses them before any
    launch, and the twin returns the wrapper's outputs (v, w f32[N, 3],
    three f32[N, C] impulses, with joints the state's f32[J, 7] impulses
    and int32 count of limit rows), with momentum and over-relaxation or
    none, cold or warm-started from the cache, where each slot's warm
    impulse is the cached impulse of its feature id, or 0."""
    case = _case(joints=joints, mass_splitting=mass_splitting)
    args = case["args"]
    n, c = args[8].shape
    jkw = ({} if not joints else dict(joints=case["joints"],
                                       joint_state=case["joint_state"],
                                       alive=case["alive"]))
    before = uk.KERNEL.launches
    for kw in (dict(momentum=0.5, iterations=10, sor=1.0),
               dict(momentum=0.0, iterations=3, sor=1.3,
                    cache=case["cache"]),
               dict(momentum=0.5, iterations=0, sor=1.0,
                    cache=case["cache"])):
        with pytest.raises(ValueError, match="run on CUDA tensors"):
            uk.solve_unified(*args, **kw, **jkw)
        out = uk.solve_unified_reference(*args, **kw, **jkw)
        want = [(n, 3)] * 2 + [(n, c)] * 3
        if joints:
            want += [(joints, jt.ROWS), ()]
        leaves = _leaves(out)
        assert [tuple(t.shape) for t in leaves] == want
        assert all(t.dtype == torch.float32 for t in leaves[:-1])
        assert leaves[-1].dtype == (torch.int32 if joints else torch.float32)
    assert uk.KERNEL.launches == before
    c_feat, feat, imp = (t.numpy() for t in case["cache"])
    want = np.zeros((n, c, 3), np.float32)
    for b, k in zip(*np.nonzero(c_feat >= 0)):
        hit = np.flatnonzero(feat[b] == c_feat[b, k])
        if hit.size:
            want[b, k] = imp[b, hit[0]]
    got = np.stack([t.numpy() for t in uk.matched_warm_start(*case["cache"])],
                   axis=-1)
    np.testing.assert_array_equal(got, want)
    assert np.count_nonzero(want) > 0


@pytest.mark.parametrize("jointed", [False, True])
def test_dense_route_on_the_cpu_calls_the_plain_twin(jointed, monkeypatch):
    """A CPU step of the dense route (boxes, or a ragdoll's jointed rows)
    hands its solve to the plain twin once, with the contact cache and,
    with joints, the set, its state and the live bodies."""
    calls = []
    plain = uk.solve_unified_reference

    def spy(*args, **kw):
        calls.append(kw)
        return plain(*args, **kw)

    monkeypatch.setattr(uk, "solve_unified_reference", spy)
    before = uk.KERNEL.launches
    inp = InputFrame.zero("cpu")
    if jointed:
        sc = build_ragdoll_pyramid(RAGDOLL, device="cpu")
        run = make_multi_step_fn(sc.static, 2, joints=sc.joints,
                                 broadphase="dense", max_neighbors=8)
        _, js = run(sc.state, inp, jt.make_joint_state(sc.joints))
        assert js.impulse.shape == (sc.joints.num_joints, jt.ROWS)
    else:
        state, static = build_falling_boxes(6, seed=1, device="cpu")
        make_multi_step_fn(static, 2, broadphase="dense")(state, inp)
    assert len(calls) == 2 and uk.KERNEL.launches == before
    for kw in calls:
        assert kw["cache"] is not None and len(kw["cache"]) == 3
        assert (kw.get("joints") is not None) == jointed
        assert (kw.get("alive") is not None) == jointed


@pytest.mark.parametrize("joints", [0, 14])
def test_plain_twin_opens_its_spans(joints, monkeypatch):
    """The plain twin opens its own spans, so its caller holds none open:
    the set-up in ``physics.solver``, and without joints the solve in the
    same span; with joints the rows' set-up in ``physics.joints``, then
    the solve's own alternating spans (``solver.solve_contacts_unified``),
    the contacts' first."""
    opened = []
    real = uk.span

    def spy(name, device=None):
        opened.append(name)
        return real(name, device)

    monkeypatch.setattr(uk, "span", spy)
    monkeypatch.setattr(sv, "span", spy)
    case = _case(joints=joints)
    jkw = ({} if not joints else dict(joints=case["joints"],
                                       joint_state=case["joint_state"],
                                       alive=case["alive"]))
    uk.solve_unified_reference(*case["args"], 0.5, iterations=2,
                               cache=case["cache"], **jkw)
    if not joints:
        assert opened == ["physics.solver"]
    else:
        assert opened == ["physics.solver", "physics.joints",
                          "physics.solver", "physics.joints"] + [
            "physics.joints", "physics.solver"] * 2


def _worlds(w=3, n=12):
    """``w`` worlds' inputs stacked on a leading axis, but inv_m and
    friction (the scene's, the same in every world) and dt; ``in_dims``
    for ``torch.func.vmap``."""
    cases = [_case(n=n, seed=s) for s in range(w)]
    bodies = [torch.stack([c["args"][i] for c in cases]) for i in range(13)]
    bodies[4], bodies[6] = cases[0]["args"][4], cases[0]["args"][6]
    cache = [torch.stack([c["cache"][k] for c in cases]) for k in range(3)]
    in_dims = tuple(None if i in (4, 6) else 0 for i in range(13)) + (0,) * 3
    return bodies, cases[0]["args"][13], cache, in_dims


def test_fold_worlds_equals_the_vmapped_plain_version():
    """A solve vmapped over worlds (the many-world steps' vmapped layout)
    folded into one call over every world's rows, partner ids moved to
    their world's rows and the unbatched scene repeated, equals the plain
    version vmapped, bit for bit; with joints, or a dt a world, the fold
    raises."""
    bodies, dt, cache, in_dims = _worlds()
    kw = dict(momentum=0.5, iterations=10, sor=1.0, ground_friction=0.5)

    def plain(*a):
        return uk.solve_unified_reference(*a[:13], dt, cache=a[13:], **kw)

    def folded(*a):
        level = uk._world_level(a)
        return uk.fold_worlds(uk.solve_unified_reference, level, a[:13], dt,
                              a[13:], **kw)

    want = torch.func.vmap(plain, in_dims=in_dims)(*bodies, *cache)
    got = torch.func.vmap(folded, in_dims=in_dims)(*bodies, *cache)
    _assert_bits_equal(got, want)
    assert bool((bodies[8] >= 0).any()) and float(want[0].abs().max()) > 0
    for bad, match in ((dict(joints=_case(joints=5)["joints"]), "no joints"),
                       (dict(dt=dt.expand(3)), "one step dt")):
        def call(*a, bad=bad):
            level = uk._world_level(a)
            if "dt" in bad:
                return uk.fold_worlds(uk.solve_unified_reference, level,
                                      a[:13], a[-1], None, **kw)
            return uk.fold_worlds(uk.solve_unified_reference, level,
                                  a[:13], dt, None, **bad, **kw)
        extra = (bad["dt"],) if "dt" in bad else ()
        with pytest.raises(ValueError, match=match):
            torch.func.vmap(call, in_dims=in_dims[:13] + (0,) * len(extra))(
                *bodies, *extra)


def _bad(kind):
    """Arguments the kernels do not take, and what the error names."""
    case = _case(joints=12)
    args, kw = list(case["args"]), dict(joints=case["joints"],
                                        joint_state=case["joint_state"],
                                        alive=case["alive"])
    if kind == "dtype":
        args[0] = args[0].double()
        return args, kw, "v must be"
    if kind == "shape":
        args[10] = args[10][:, :-1]
        return args, kw, "c_normal must be"
    if kind == "index_dtype":
        args[8] = args[8].long()
        return args, kw, "c_b must be"
    if kind == "device":
        args[6] = args[6].to("meta")
        return args, kw, "friction must be"
    if kind == "alive":
        return args, dict(kw, alive=kw["alive"].to(torch.uint8)), \
            "alive must be"
    if kind == "budget":
        wide = _case(c=uk.MAX_C + 1)
        return list(wide["args"]), {}, "past MAX_C"
    if kind == "cache":
        c_feat, feat, imp = case["cache"]
        return args, dict(kw, cache=(c_feat, feat.long(), imp)), \
            "contact_feat must be"
    if kind == "cache_width":
        c_feat, _, _ = case["cache"]
        n = args[0].shape[0]
        feat = torch.full((n, uk.MAX_C + 1), -1, dtype=torch.int32)
        imp = torch.zeros((n, uk.MAX_C + 1, 3))
        return args, dict(kw, cache=(c_feat, feat, imp)), "past MAX_C"
    if kind == "joint_table":
        joints = case["joints"]
        joints.kind = joints.kind.to(torch.int32)
        return args, kw, "kind must be"
    if kind == "impulse":
        kw["joint_state"] = jt.JointState(
            impulse=kw["joint_state"].impulse[:-1],
            limit_rows=kw["joint_state"].limit_rows)
        return args, kw, "impulse must be"
    if kind == "body_rows":
        joints = case["joints"]
        n = args[0].shape[0]
        joints.body_rows = torch.full((n, uk.MAX_C + 1),
                                      2 * joints.num_joints,
                                      dtype=torch.int32)
        return args, kw, "past MAX_C"
    return args, kw, "run on CUDA tensors"


@pytest.mark.parametrize("kind", ["dtype", "shape", "index_dtype", "device",
                                  "alive", "budget", "cache", "cache_width",
                                  "joint_table", "impulse", "body_rows",
                                  "cpu", "batched", "dtensor"])
def test_check_inputs_refuses(kind):
    if kind == "dtensor":
        # the sharded modes' arrays: a DTensor on a one-rank gloo group
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import Replicate, distribute_tensor

        args = list(_case()["args"])
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            args[0] = distribute_tensor(args[0], DeviceMesh("cpu", [0]),
                                        [Replicate()])
            before = uk.KERNEL.launches
            with pytest.raises(ValueError, match="got a DTensor"):
                uk.solve_unified(*args, 0.5)
            assert uk.KERNEL.launches == before
        finally:
            dist.destroy_process_group()
        return
    if kind == "batched":
        # a functorch-batched tensor has no pointer of its own to hand over
        case = _case()
        args = case["args"]
        with pytest.raises(ValueError, match="functorch-batched"):
            torch.func.vmap(lambda v: uk.check_inputs(v, *args[1:])
                            or v)(torch.stack([args[0], args[0]]))
        return
    args, kw, match = _bad(kind)
    before = uk.KERNEL.launches
    with pytest.raises(ValueError, match=match):
        uk.solve_unified(*args, 0.5, **kw)
    assert uk.KERNEL.launches == before
