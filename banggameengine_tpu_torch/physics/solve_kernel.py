"""The transposed contact solve in hand-written CUDA.

:func:`solve_contacts` launches the kernels in ``csrc/contact_solve.cu``,
which compute :func:`solve_contacts_reference`: one set-up launch
(inertia, lever arms, tangents, effective masses, bias targets,
mass-splitting counts and the warm impulses), then one launch a Jacobi
sweep, each reading the velocities of the sweep before and writing the
other buffer of a pair: ``iterations + 1`` launches in one launcher call,
for any N and a budget C of at most :data:`MAX_C`.  Given the contact
cache (``cache=``, as ``step._solve`` hands it over), the set-up also
matches the warm impulses by feature id (:func:`cached_warm_start`) and
the last launch writes the refreshed cache (:func:`refreshed_cache`).  The
plain version, :func:`solve_contacts_reference`, is its contract: every
output equals it bit for bit on the card where a body's cached feature ids
are unique, as the step keeps them.  No TPU kernel stands behind it (XLA
fuses the JAX package's ``solve_contacts_t``), so it has no Pallas
counterpart.  :func:`contact_t.solve_contacts_t` takes it for CUDA
tensors and the plain version for the others.
"""

from __future__ import annotations

import ctypes
import os

import torch

from banggameengine_tpu_torch import cuda_build

Tensor = torch.Tensor

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                       "contact_solve.cu")
# uncontracted f32 arithmetic, as PyTorch's eager ops round it
_EXTRA_FLAGS = ("--fmad=false",)
_SLOT_PLANES = 17      # == kSlotPlanes of the source
_BODY_PLANES = 8       # == kBodyPlanes
# the widest budget at which the kernels' sum over a body's slots is ATen's
# (four accumulators over c mod 4, probed on the card for C = 1..40 at
# N = 2..65,536; ATen splits the reduction otherwise, as at C = 255)
MAX_C = 40

_ptr, _i32, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class _Args(ctypes.Structure):
    """The kernels' ``Args``, field for field."""
    _fields_ = [
        ("vel", _ptr), ("vel_stride", _i32),
        ("ang", _ptr), ("ang_stride", _i32),
        ("pos", _ptr), ("pos_stride", _i32),
        ("quat", _ptr), ("quat_stride", _i32),
        ("inertia", _ptr), ("inertia_stride", _i32),
        ("inv_m", _ptr), ("inv_m_stride", _i32),
        ("friction", _ptr), ("friction_stride", _i32),
        ("restitution", _ptr), ("restitution_stride", _i32),
        ("prt", _ptr), ("pt", _ptr * 3), ("nrm", _ptr * 3), ("dep", _ptr),
        ("valid", _ptr), ("warm", _ptr * 3), ("warm_stride", _i32),
        ("c_feat", _ptr), ("cache_feat", _ptr), ("cf_stride_b", _i32),
        ("cf_stride_n", _i32), ("cache_imp", _ptr), ("ci_stride_b", _i32),
        ("ci_stride_k", _i32), ("ci_stride_n", _i32), ("cb", _i32),
        ("feat_out", _ptr), ("imp_out", _ptr),
        ("dt", _ptr), ("n", _i32), ("c", _i32),
        ("ground_friction", _f32), ("momentum", _f32),
        ("use_momentum", _i32),
        ("slots", _ptr), ("mode", _ptr), ("body", _ptr), ("lam", _ptr),
        ("prev", _ptr),
    ]


def check_inputs(vel, ang, pos, quat, inv_m, inv_inertia_body, c_prt, c_ptx,
                 c_pty, c_ptz, c_nx, c_ny, c_nz, c_dep, c_valid, friction,
                 restitution, dt, warm, cache=None) -> None:
    """Raise ValueError unless the inputs are what the kernel takes by
    pointer: plain tensors (no DTensor, no functorch-batched tensor) on one
    CUDA device, f32 bodies ([N, 3], [N, 4] and [N] rows), int32 partner
    ids, f32 contact planes and a bool validity plane of one [C, N]
    shape with C at most :data:`MAX_C`, an f32[] ``dt``, three f32 [C, N]
    warm planes where given, and the cache where given: int32 feature ids
    [C, N] and [CB, N], f32 impulses [CB, 3, N].  Partner ids past the
    last body are not checked here (that would wait on the card): the
    kernel traps on one, as the plain version's gather faults."""
    n = vel.shape[0] if vel.dim() == 2 else -1
    cn = tuple(c_prt.shape) if c_prt.dim() == 2 else (-1, n)
    device = vel.device
    f32, i32 = (torch.float32,), (torch.int32,)
    want = [("vel", vel, f32, (n, 3)), ("ang", ang, f32, (n, 3)),
            ("pos", pos, f32, (n, 3)), ("quat", quat, f32, (n, 4)),
            ("inv_m", inv_m, f32, (n,)),
            ("inv_inertia_body", inv_inertia_body, f32, (n, 3)),
            ("friction", friction, f32, (n,)),
            ("restitution", restitution, f32, (n,)),
            ("c_prt", c_prt, i32, (cn[0], n)),
            ("c_valid", c_valid, (torch.bool,), cn), ("dt", dt, f32, ())]
    want += [(name, t, f32, cn) for name, t in zip(
        ("c_ptx", "c_pty", "c_ptz", "c_nx", "c_ny", "c_nz", "c_dep"),
        (c_ptx, c_pty, c_ptz, c_nx, c_ny, c_nz, c_dep))]
    if warm is not None:
        if len(warm) != 3:
            raise ValueError(f"solve_contacts: warm must be 3 planes, got "
                             f"{len(warm)}")
        want += [(f"warm[{i}]", t, f32, cn) for i, t in enumerate(warm)]
    if cache is not None:
        c_feat, cache_feat, cache_imp = cache
        cb = cache_feat.shape[0] if cache_feat.dim() == 2 else -1
        want += [("c_feat", c_feat, i32, cn),
                 ("cache_feat", cache_feat, i32, (cb, n)),
                 ("cache_imp", cache_imp, f32, (cb, 3, n))]
    for name, t, dtypes, shape in want:
        if not isinstance(t, Tensor):
            raise ValueError(f"solve_contacts: {name} must be a tensor, got "
                             f"{type(t).__name__}")
        kind = ("functorch-batched"
                if torch._C._functorch.is_functorch_wrapped_tensor(t)
                else None if type(t) is Tensor else type(t).__name__)
        if kind is not None:
            raise ValueError(f"solve_contacts: {name} must be a plain "
                             f"tensor, which the kernel reads by pointer, "
                             f"got a {kind} tensor")
        if (t.device != device or t.dtype not in dtypes
                or tuple(t.shape) != shape):
            raise ValueError(
                f"solve_contacts: {name} must be "
                f"{'/'.join(map(str, dtypes))}{list(shape)} on {device}, "
                f"got {t.dtype}{list(t.shape)} on {t.device}")
    if cn[0] > MAX_C:
        raise ValueError(f"solve_contacts: a budget of C = {cn[0]} slots, "
                         f"past MAX_C = {MAX_C}, where the kernel's order of "
                         f"summing slots is no longer ATen's")
    if device.type != "cuda":
        raise ValueError(f"solve_contacts: the kernel runs on CUDA tensors, "
                         f"got {device}")


def _rows(t: Tensor) -> Tensor:
    """``t`` with unit column stride (the kernel takes any row stride, so
    the packed rows of the all-pairs route are read in place)."""
    return t if t.dim() < 2 or t.stride(1) == 1 else t.contiguous()


def _warm_planes(warm):
    """The warm planes with unit column stride and one row stride between
    them (the unbound rows of one ``[C, 3, N]`` tensor as they are)."""
    warm = [_rows(t) for t in warm]
    if len({t.stride(0) for t in warm}) != 1:
        warm = [t.contiguous() for t in warm]
    return warm


def solve_contacts(vel, ang, pos, quat, inv_m, inv_inertia_body, c_prt,
                   c_ptx, c_pty, c_ptz, c_nx, c_ny, c_nz, c_dep, c_valid,
                   friction, restitution, dt, iterations: int = 10,
                   ground_friction: float = 0.5, warm=None,
                   return_lambdas: bool = False, momentum: float = 0.0,
                   cache=None):
    """:func:`solve_contacts_reference` by the CUDA kernels on the current
    stream: (vel, ang), each [N, 3], and with ``return_lambdas`` the
    accumulated (ln, lt1, lt2), each [C, N]; with ``cache`` (c_feat,
    cache_feat, cache_imp) the refreshed cache (feat [N, C], imp
    [N, C, 3]) in their place.  Invalid inputs raise ValueError
    (:func:`check_inputs`)."""
    if cache is not None:
        warm, return_lambdas = None, False
    check_inputs(vel, ang, pos, quat, inv_m, inv_inertia_body, c_prt, c_ptx,
                 c_pty, c_ptz, c_nx, c_ny, c_nz, c_dep, c_valid, friction,
                 restitution, dt, warm, cache)
    c, n = c_prt.shape
    device = vel.device
    iterations = max(int(iterations), 0)      # range() of a negative count
    use_momentum = bool(momentum)
    vel, ang, pos, quat, inertia = (_rows(t) for t in (
        vel, ang, pos, quat, inv_inertia_body))
    planes = [t.contiguous() for t in (c_prt, c_ptx, c_pty, c_ptz, c_nx,
                                       c_ny, c_nz, c_dep, c_valid)]
    slots = torch.empty((_SLOT_PLANES, c, n), dtype=torch.float32,
                        device=device)
    mode = torch.empty((c, n), dtype=torch.uint8, device=device)
    body = torch.empty((_BODY_PLANES, n), dtype=torch.float32, device=device)
    lam = torch.empty((6 if use_momentum else 3, c, n), dtype=torch.float32,
                      device=device)
    pairs = torch.empty((2 if iterations else 1, 2, n, 3),
                        dtype=torch.float32, device=device)
    args = _Args(
        vel.data_ptr(), vel.stride(0), ang.data_ptr(), ang.stride(0),
        pos.data_ptr(), pos.stride(0), quat.data_ptr(), quat.stride(0),
        inertia.data_ptr(), inertia.stride(0), inv_m.data_ptr(),
        inv_m.stride(0), friction.data_ptr(), friction.stride(0),
        restitution.data_ptr(), restitution.stride(0), planes[0].data_ptr(),
        (_ptr * 3)(*(t.data_ptr() for t in planes[1:4])),
        (_ptr * 3)(*(t.data_ptr() for t in planes[4:7])),
        planes[7].data_ptr(), planes[8].data_ptr(),
        dt=dt.data_ptr(), n=n, c=c, ground_friction=ground_friction,
        momentum=momentum, use_momentum=int(use_momentum),
        slots=slots.data_ptr(), mode=mode.data_ptr(), body=body.data_ptr(),
        lam=lam.data_ptr(),
        prev=lam[3].data_ptr() if use_momentum else None)
    if warm is not None:
        warm = _warm_planes(warm)
        args.warm = (_ptr * 3)(*(t.data_ptr() for t in warm))
        args.warm_stride = warm[0].stride(0)
    if cache is not None:
        c_feat, cache_feat, cache_imp = cache
        c_feat = c_feat.contiguous()
        feat = torch.empty((n, c), dtype=torch.int32, device=device)
        imp = torch.empty((n, c, 3), dtype=torch.float32, device=device)
        args.c_feat = c_feat.data_ptr()
        args.cache_feat, args.cache_imp = (cache_feat.data_ptr(),
                                           cache_imp.data_ptr())
        args.cf_stride_b, args.cf_stride_n = cache_feat.stride()
        (args.ci_stride_b, args.ci_stride_k,
         args.ci_stride_n) = cache_imp.stride()
        args.cb = cache_feat.shape[0]
        args.feat_out, args.imp_out = feat.data_ptr(), imp.data_ptr()
    b = pairs[-1]
    KERNEL.launch(device, ctypes.byref(args), iterations,
                  pairs[0, 0].data_ptr(), pairs[0, 1].data_ptr(),
                  b[0].data_ptr(), b[1].data_ptr())
    out = pairs[iterations % 2]
    if cache is not None:
        return out[0], out[1], (feat, imp)
    if return_lambdas:
        return out[0], out[1], (lam[0], lam[1], lam[2])
    return out[0], out[1]


def cached_warm_start(c_feat, cache_feat, cache_imp):
    """Cached impulses [C, 3, N] of this step's contacts ``c_feat`` [C, N],
    matched by feature id against ``cache_feat`` [CB, N] / ``cache_imp``
    [CB, 3, N].  The match is a one-hot select (feature ids are unique per
    row), so summing its products moves each cached impulse exactly."""
    eq = ((c_feat[:, None, :] == cache_feat[None, :, :])
          & (c_feat >= 0)[:, None, :]).to(torch.float32)       # [C, CB, N]
    return (eq[:, :, None, :] * cache_imp[None]).sum(dim=1)


def refreshed_cache(c_valid, c_feat, lams):
    """The contact cache after a solve: feature ids [N, C] (-1 where a
    slot is not valid) and accumulated impulses [N, C, 3] (0 there)."""
    ln, lt1, lt2 = lams
    imp = torch.where(c_valid.T[..., None],
                      torch.stack([ln.T, lt1.T, lt2.T], dim=-1), 0.0)
    feat = torch.where(c_valid, c_feat, -1).T                  # [N, C]
    return feat, imp


def solve_contacts_reference(vel, ang, pos, quat, inv_m, inv_inertia_body,
                             c_prt, c_ptx, c_pty, c_ptz, c_nx, c_ny, c_nz,
                             c_dep, c_valid, friction, restitution, dt,
                             iterations: int = 10,
                             ground_friction: float = 0.5, warm=None,
                             return_lambdas: bool = False,
                             momentum: float = 0.0, cache=None):
    """Plain PyTorch version of :func:`solve_contacts`, on any device:
    :func:`contact_t.solve_contacts_t_reference`, and with ``cache`` the
    feature match before it and the refreshed cache after it."""
    from banggameengine_tpu_torch.physics import contact_t

    args = (vel, ang, pos, quat, inv_m, inv_inertia_body, c_prt, c_ptx,
            c_pty, c_ptz, c_nx, c_ny, c_nz, c_dep, c_valid, friction,
            restitution, dt, iterations, ground_friction)
    if cache is None:
        return contact_t.solve_contacts_t_reference(
            *args, warm, return_lambdas, momentum)
    warm = cached_warm_start(*cache)
    vel, ang, lams = contact_t.solve_contacts_t_reference(
        *args, warm.unbind(1), True, momentum)
    return vel, ang, refreshed_cache(c_valid, cache[0], lams)


KERNEL = cuda_build.HandKernel(
    "solve", "bge_contact_solve", _SOURCE,
    [ctypes.POINTER(_Args), _i32] + [_ptr] * 5,
    flags=_EXTRA_FLAGS, wrapper=solve_contacts,
    plain=solve_contacts_reference, replaces=None)
load_kernel_library = KERNEL.load
