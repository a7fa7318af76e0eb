"""The dense route's unified Jacobi solve in hand-written CUDA.

:func:`solve_unified` launches the kernels in ``csrc/unified_solve.cu``,
which compute :func:`solve_unified_reference`: each slot's friction and
restitution, the world inverse inertias, the contacts' warm start matched
by feature id from the contact cache (``cache=``, as
``step._contacts_dense`` hands it over), the joint rows
(:func:`joints.joint_rows`) and :func:`solver.solve_contacts_unified`'s
warm-started, heavy-ball, mass-splitting Jacobi iterations over the
contacts and the rows together.  Each launch is its own launcher call, so
the registry counts them all: with joints the rows' set-up (in the span
``physics.joints``), then the contacts' set-up and two launches a sweep,
the joints' and the bodies' (in the span ``physics.solver``): 22 a step of
10 iterations; without joints the contacts' set-up and one a sweep, 11, in
``physics.solver``.  Both versions open these spans themselves.  The plain
version is its contract: every output equals it bit for bit on the card
where a body's cached feature ids are unique, as the step keeps them, and
``joints.body_rows`` is :func:`joints.make_joint_set`'s.  No TPU kernel
stands behind it (the JAX package has no joints and XLA fuses its contact
solve), so it has no Pallas counterpart.  The dense and grid routes of
``physics/step.py`` take it for CUDA tensors and the plain version for the
others; on the card a functorch-batched or DTensor input raises
ValueError (:func:`check_inputs`).
"""

from __future__ import annotations

import ctypes
import os

import torch

from banggameengine_tpu_torch import cuda_build
from banggameengine_tpu_torch.physics import joints as jt
from banggameengine_tpu_torch.physics import solver as sv
from banggameengine_tpu_torch.utils.profiling import span

Tensor = torch.Tensor

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                       "unified_solve.cu")
# uncontracted f32 arithmetic, as PyTorch's eager ops round it
_EXTRA_FLAGS = ("--fmad=false",)
_SLOT_PLANES = 20      # == kSlotPlanes of the source
_BODY_PLANES = 13      # == kBodyPlanes
_ROW_FLOATS = 16       # == kRowFloats
_LAM_FLOATS = 8        # == kLamFloats
_SIDE_FLOATS = 8       # == kSideFloats
# the widest budget of slots, cached slots or a body's joint entries at
# which the kernels' sums over them are ATen's (four accumulators over the
# index mod 4, probed on the card for 1 to 40 terms at N = 9 to 36,864)
MAX_C = 40

_ptr, _i32, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class _Args(ctypes.Structure):
    """The kernels' ``Args``, field for field."""
    _fields_ = [
        ("vel", _ptr), ("ang", _ptr), ("pos", _ptr), ("quat", _ptr),
        ("inv_m", _ptr), ("inertia", _ptr), ("friction", _ptr),
        ("restitution", _ptr), ("alive", _ptr),
        ("prt", _ptr), ("pt", _ptr), ("nrm", _ptr), ("dep", _ptr),
        ("valid", _ptr), ("c_feat", _ptr), ("cache_feat", _ptr),
        ("cache_imp", _ptr),
        ("cb", _i32), ("dt", _ptr), ("n", _i32), ("c", _i32),
        ("ground_friction", _f32), ("momentum", _f32), ("sor", _f32),
        ("use_momentum", _i32), ("use_sor", _i32), ("j", _i32), ("jb", _i32),
        ("mass_splitting", _i32), ("body_a", _ptr), ("body_b", _ptr),
        ("kind", _ptr), ("origin_a", _ptr), ("origin_b", _ptr),
        ("frame_a", _ptr), ("frame_b", _ptr), ("limit_lo", _ptr),
        ("limit_hi", _ptr), ("body_rows", _ptr), ("impulse", _ptr),
        ("slots", _ptr), ("mode", _ptr), ("body", _ptr), ("lam", _ptr),
        ("prev", _ptr), ("rows", _ptr), ("jlam", _ptr), ("table", _ptr),
        ("lam_out", _ptr), ("jlam_out", _ptr), ("limit_rows", _ptr),
    ]


def matched_warm_start(c_feat, contact_feat, contact_imp):
    """The previous step's impulses of this step's contacts ``c_feat``
    [N, C], matched by feature id against the cache ``contact_feat``
    [N, C0] / ``contact_imp`` [N, C0, 3]: feature ids are unique within a
    row, so the masked sum moves one cached impulse.  (ln, lt1, lt2), each
    [N, C]."""
    match = ((c_feat[:, :, None] == contact_feat[:, None, :])
             & (c_feat >= 0)[:, :, None]).to(torch.float32)  # [N, C, C0]
    return (match[..., None] * contact_imp[:, None]).sum(dim=2).unbind(-1)


def check_inputs(v, w, pos, quat, inv_m, inv_inertia_body, friction,
                 restitution, c_b, c_point, c_normal, c_depth, c_valid, dt,
                 cache=None, joints=None, joint_state=None,
                 alive=None) -> None:
    """Raise ValueError unless the inputs are what the kernels take by
    pointer: plain tensors (no DTensor, no functorch-batched tensor) on one
    CUDA device; f32 bodies ([N, 3], [N, 4] and [N] rows), int32 partner
    ids, f32 contact planes and a bool validity plane of one [N, C] shape
    (points and normals [N, C, 3]) with C at most :data:`MAX_C`, an f32[]
    ``dt``, the cache where given (int32 ids [N, C] and [N, CB], f32
    impulses [N, CB, 3], CB at most ``MAX_C``), and with ``joints`` its
    table (int32 bodies, int8 kinds, f32 anchors, frames and limits of J
    joints; int32 ``body_rows`` [N, JB], JB at most ``MAX_C``), f32
    impulses [J, 7] in ``joint_state`` and bool ``alive`` [N].  Partner or
    body ids past the last body are not checked here (that would wait on
    the card): the kernels trap on one, as the plain version's gather
    faults."""
    n = v.shape[0] if isinstance(v, Tensor) and v.dim() == 2 else -1
    nc = (tuple(c_b.shape) if isinstance(c_b, Tensor) and c_b.dim() == 2
          else (n, -1))
    device = v.device if isinstance(v, Tensor) else None
    f32, i32 = (torch.float32,), (torch.int32,)
    want = [("v", v, f32, (n, 3)), ("w", w, f32, (n, 3)),
            ("pos", pos, f32, (n, 3)), ("quat", quat, f32, (n, 4)),
            ("inv_m", inv_m, f32, (n,)),
            ("inv_inertia_body", inv_inertia_body, f32, (n, 3)),
            ("friction", friction, f32, (n,)),
            ("restitution", restitution, f32, (n,)),
            ("c_b", c_b, i32, (n, nc[1])),
            ("c_point", c_point, f32, nc + (3,)),
            ("c_normal", c_normal, f32, nc + (3,)),
            ("c_depth", c_depth, f32, nc),
            ("c_valid", c_valid, (torch.bool,), nc), ("dt", dt, f32, ())]
    cb = 0
    if cache is not None:
        c_feat, feat, imp = cache
        cb = (feat.shape[1] if isinstance(feat, Tensor) and feat.dim() == 2
              else -1)
        want += [("c_feat", c_feat, i32, nc),
                 ("contact_feat", feat, i32, (n, cb)),
                 ("contact_imp", imp, f32, (n, cb, 3))]
    jb = 0
    if joints is not None:
        j = joints.num_joints
        rows = joints.body_rows
        jb = rows.shape[1] if rows.dim() == 2 else -1
        want += [("body_a", joints.body_a, i32, (j,)),
                 ("body_b", joints.body_b, i32, (j,)),
                 ("kind", joints.kind, (torch.int8,), (j,)),
                 ("origin_a", joints.origin_a, f32, (j, 3)),
                 ("origin_b", joints.origin_b, f32, (j, 3)),
                 ("frame_a", joints.frame_a, f32, (j, 4)),
                 ("frame_b", joints.frame_b, f32, (j, 4)),
                 ("limit_lo", joints.limit_lo, f32, (j,)),
                 ("limit_hi", joints.limit_hi, f32, (j,)),
                 ("body_rows", rows, i32, (n, jb)),
                 ("impulse", joint_state.impulse, f32, (j, jt.ROWS)),
                 ("alive", alive, (torch.bool,), (n,))]
    for name, t, dtypes, shape in want:
        if not isinstance(t, Tensor):
            raise ValueError(f"solve_unified: {name} must be a tensor, got "
                             f"{type(t).__name__}")
        kind = ("functorch-batched"
                if torch._C._functorch.is_functorch_wrapped_tensor(t)
                else None if type(t) is Tensor else type(t).__name__)
        if kind is not None:
            raise ValueError(f"solve_unified: {name} must be a plain "
                             f"tensor, which the kernel reads by pointer, "
                             f"got a {kind} tensor")
        if (t.device != device or t.dtype not in dtypes
                or tuple(t.shape) != shape):
            raise ValueError(
                f"solve_unified: {name} must be "
                f"{'/'.join(map(str, dtypes))}{list(shape)} on {device}, "
                f"got {t.dtype}{list(t.shape)} on {t.device}")
    for what, width in (("a budget of C", nc[1]), ("a cache of CB", cb),
                        ("a body's JB", jb)):
        if width > MAX_C:
            raise ValueError(f"solve_unified: {what} = {width} slots, past "
                             f"MAX_C = {MAX_C}, where the kernels' order of "
                             f"summing them is no longer ATen's")
    if device.type != "cuda":
        raise ValueError(f"solve_unified: the kernels run on CUDA tensors, "
                         f"got {device}")


def solve_unified(v, w, pos, quat, inv_m, inv_inertia_body, friction,
                  restitution, c_b, c_point, c_normal, c_depth, c_valid, dt,
                  momentum: float, iterations: int = 10, sor: float = 1.0,
                  ground_friction: float = 0.5, cache=None, joints=None,
                  joint_state=None, alive=None):
    """:func:`solve_unified_reference` by the CUDA kernels on the current
    stream: (v, w, (ln, lt1, lt2)), and with ``joints`` the joints' new
    :class:`joints.JointState` (the rows' accumulated impulses [J, 7], the
    limit rows on) last; the warm start matched from ``cache``, or none.
    Invalid inputs raise ValueError (:func:`check_inputs`)."""
    bodies = (v, w, pos, quat, inv_m, inv_inertia_body, friction,
              restitution, c_b, c_point, c_normal, c_depth, c_valid)
    level = _world_level(bodies + (dt,) + tuple(cache or ()))
    if level is not None:
        return fold_worlds(solve_unified, level, bodies, dt, cache,
                           momentum=momentum, iterations=iterations, sor=sor,
                           ground_friction=ground_friction, joints=joints)
    check_inputs(v, w, pos, quat, inv_m, inv_inertia_body, friction,
                 restitution, c_b, c_point, c_normal, c_depth, c_valid, dt,
                 cache, joints, joint_state, alive)
    n, c = c_b.shape
    device = v.device
    iterations = max(int(iterations), 0)      # range() of a negative count
    use_momentum = bool(momentum)
    ins = [t.contiguous() for t in (v, w, pos, quat, inv_m, inv_inertia_body,
                                    friction, restitution, c_b, c_point,
                                    c_normal, c_depth, c_valid)]
    f32 = dict(dtype=torch.float32, device=device)
    slots = torch.empty((_SLOT_PLANES, c, n), **f32)
    mode = torch.empty((c, n), dtype=torch.uint8, device=device)
    body = torch.empty((_BODY_PLANES, n), **f32)
    lam = torch.empty((6 if use_momentum else 3, c, n), **f32)
    pairs = torch.empty((2 if iterations else 1, 2, n, 3), **f32)
    lam_out = torch.empty((n, c, 3), **f32)
    args = _Args(*(t.data_ptr() for t in ins[:8]), None,
                 *(t.data_ptr() for t in ins[8:]),
                 dt=dt.data_ptr(), n=n, c=c, ground_friction=ground_friction,
                 momentum=momentum, sor=sor,
                 use_momentum=int(use_momentum), use_sor=int(sor != 1.0),
                 slots=slots.data_ptr(), mode=mode.data_ptr(),
                 body=body.data_ptr(), lam=lam.data_ptr(),
                 prev=lam[3].data_ptr() if use_momentum else None,
                 lam_out=lam_out.data_ptr())
    if cache is not None:
        cache = [t.contiguous() for t in cache]
        args.c_feat, args.cache_feat, args.cache_imp = (
            t.data_ptr() for t in cache)
        args.cb = cache[1].shape[1]
    state = None
    if joints is not None:
        j = joints.num_joints
        table = [t.contiguous() for t in (
            joints.body_a, joints.body_b, joints.kind, joints.origin_a,
            joints.origin_b, joints.frame_a, joints.frame_b,
            joints.limit_lo, joints.limit_hi, joints.body_rows,
            joint_state.impulse, alive)]
        (args.body_a, args.body_b, args.kind, args.origin_a, args.origin_b,
         args.frame_a, args.frame_b, args.limit_lo, args.limit_hi,
         args.body_rows, args.impulse, args.alive) = (
            t.data_ptr() for t in table)
        args.j, args.jb = j, joints.body_rows.shape[1]
        args.mass_splitting = int(joints.mass_splitting)
        rows = torch.empty((j, jt.ROWS, _ROW_FLOATS), **f32)
        jlam = torch.empty((2, j, _LAM_FLOATS), **f32)
        sides = torch.empty((2 * j, _SIDE_FLOATS), **f32)
        state = jt.JointState(
            impulse=torch.empty((j, jt.ROWS), **f32),
            limit_rows=torch.empty((), dtype=torch.int32, device=device))
        args.rows, args.jlam, args.table = (
            rows.data_ptr(), jlam.data_ptr(), sides.data_ptr())
        args.jlam_out = state.impulse.data_ptr()
        args.limit_rows = state.limit_rows.data_ptr()
    b = pairs[-1]
    out_ptrs = (pairs[0, 0].data_ptr(), pairs[0, 1].data_ptr(),
                b[0].data_ptr(), b[1].data_ptr())

    def launch(stage, i=0):
        KERNEL.launch(device, ctypes.byref(args), stage, i, iterations,
                      *out_ptrs)

    if joints is not None:
        with span("physics.joints", device):
            launch(0)
    with span("physics.solver", device):
        launch(1)
        for i in range(iterations):
            if joints is not None:
                launch(2, i)
            launch(3, i)
    out = pairs[iterations % 2]
    lams = lam_out.unbind(-1)
    if joints is None:
        return out[0], out[1], lams
    return out[0], out[1], lams, state


def _world_level(tensors) -> int | None:
    """The vmap level of the functorch-batched tensors among ``tensors``,
    None where none is."""
    fn = torch._C._functorch
    levels = {fn.maybe_get_level(t) for t in tensors
              if isinstance(t, Tensor) and fn.is_batchedtensor(t)}
    return max(levels) if levels else None


def fold_worlds(solve, level: int, bodies, dt, cache, joints=None, **kw):
    """``solve`` (:func:`solve_unified` or its plain twin) of a call vmapped
    over worlds (the many-world steps' vmapped layout), as one call over
    every world's rows: the tensors batched at ``level`` unwrapped with
    their world axis first, the unbatched ones repeated for each world,
    each world's rows after the last world's, partner ids moved to their
    world's rows (ids past a world's bodies stay past every body, where
    the kernels trap as the plain version's gather faults), and the
    results batched at ``level`` again.  A vmapped call takes no joints,
    and one step ``dt`` for every world: either raises ValueError."""
    fn = torch._C._functorch
    if joints is not None:
        raise ValueError("solve_unified: a call vmapped over worlds takes "
                         "no joints (the many-world steps run joints on "
                         "the flat layout)")
    if isinstance(dt, Tensor) and fn.is_batchedtensor(dt):
        raise ValueError("solve_unified: a call vmapped over worlds takes "
                         "one step dt for every world")
    worlds = {fn.get_unwrapped(t).shape[fn.maybe_get_bdim(t)]
              for t in (*bodies, *(cache or ()))
              if isinstance(t, Tensor) and fn.maybe_get_level(t) == level}
    (w,) = worlds

    def unbatched(t):
        if isinstance(t, Tensor) and fn.maybe_get_level(t) == level:
            return fn.get_unwrapped(t).movedim(fn.maybe_get_bdim(t), 0)
        return t.expand((w,) + tuple(t.shape))

    def rows(t):
        t = unbatched(t)
        return t.reshape((-1,) + tuple(t.shape[2:]))

    c_b = unbatched(bodies[8])
    n = c_b.shape[1]
    first = (torch.arange(w, dtype=c_b.dtype, device=c_b.device)
             * n)[:, None, None]
    c_b = torch.where(c_b < 0, c_b, torch.where(c_b < n, c_b + first, w * n))
    flat = [rows(t) for t in bodies]
    flat[8] = c_b.reshape(w * n, -1)
    out = solve(*flat, dt, cache=None if cache is None else [
        rows(t) for t in cache], **kw)

    def batched(t):
        return fn._add_batch_dim(t.reshape((w, n) + tuple(t.shape[1:])), 0,
                                 level)

    v_out, w_out, lams = out
    return batched(v_out), batched(w_out), tuple(batched(t) for t in lams)


def solve_unified_reference(v, w, pos, quat, inv_m, inv_inertia_body,
                            friction, restitution, c_b, c_point, c_normal,
                            c_depth, c_valid, dt, momentum: float,
                            iterations: int = 10, sor: float = 1.0,
                            ground_friction: float = 0.5, cache=None,
                            joints=None, joint_state=None, alive=None):
    """Plain PyTorch version of :func:`solve_unified`, on any device: each
    slot's friction and restitution (the ground's where the partner is the
    static world, -1), the world inverse inertias, with ``cache`` the warm
    start matched from it (:func:`matched_warm_start`), in the span
    ``physics.solver``; without ``joints`` the solve in the same span; with
    them the rows at the poses ``pos``/``quat`` of the bodies ``alive``
    (:func:`joints.joint_rows`, in the span ``physics.joints``), then
    :func:`solver.solve_contacts_unified`, which opens its own spans where
    joints are given."""
    with span("physics.solver", v.device):
        safe_b = c_b.clamp_min(0).to(torch.int64)
        static_side = c_b < 0
        fric = friction[:, None]
        c_mu = torch.where(static_side, fric * ground_friction,
                           fric * friction[safe_b])
        c_e = torch.where(static_side, 0.0,
                          restitution[:, None] * restitution[safe_b])
        inv_i_w = sv.inv_inertia_world(quat, inv_inertia_body)
        warm = None if cache is None else matched_warm_start(*cache)
        solve = (v, w, pos, inv_m, inv_i_w, c_b, c_point, c_normal, c_depth,
                 c_valid, c_mu, c_e, dt, warm, momentum)
        if joints is None:
            return sv.solve_contacts_unified(*solve, iterations=iterations,
                                             sor=sor)
    with span("physics.joints", v.device):
        rows = jt.joint_rows(joints, joint_state, pos, quat, alive, inv_m,
                             inv_i_w, dt, contacts=c_valid)
    v, w, lams, impulse = sv.solve_contacts_unified(
        *solve, iterations=iterations, sor=sor, joints=rows)
    return v, w, lams, jt.JointState(impulse=impulse,
                                     limit_rows=rows.limit_rows)


KERNEL = cuda_build.HandKernel(
    "unified", "bge_unified_solve", _SOURCE,
    [ctypes.POINTER(_Args), _i32, _i32, _i32] + [_ptr] * 5,
    flags=_EXTRA_FLAGS, wrapper=solve_unified,
    plain=solve_unified_reference, replaces=None)
load_kernel_library = KERNEL.load
