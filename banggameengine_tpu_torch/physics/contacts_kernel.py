"""Box-box and ground contacts in one CUDA kernel.

:func:`box_contacts` launches the kernel in ``csrc/box_contacts.cu``,
which computes :func:`contact_t.box_contacts_t_reference` for a box-only
call (no ``shape_type``): the SAT, the 17 candidate slots, the 4-point
cap, the ground corners and the per-body compaction, in one launch after a
4-byte memset of the overflow count, for any K (lists longer than a block
of 256 pairs take its wide form).  The plain version is its contract:
every output equals it bit for bit on the card.  No TPU kernel stands
behind it (XLA fuses the JAX package's ``box_contacts_t``), so it has no
Pallas counterpart.  :func:`contact_t.box_contacts_t` routes CUDA tensors
of a box-only call here and everything else to the plain version.
"""

from __future__ import annotations

import ctypes
import os

import torch

from banggameengine_tpu_torch import cuda_build

Tensor = torch.Tensor

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                       "box_contacts.cu")
# uncontracted f32 arithmetic, as PyTorch's eager ops round it
_EXTRA_FLAGS = ("--fmad=false",)


def check_inputs(pos: Tensor, quat: Tensor, half: Tensor, nb_idx: Tensor,
                 nb_valid: Tensor, ground_valid: Tensor, budget: int,
                 orig_id: Tensor | None) -> None:
    """Raise ValueError unless the inputs are what the kernel takes: one
    CUDA device, f32 poses and extents, int32 and bool lists of at least
    one slot (the plain version takes no empty list), an int32 or int64
    ``orig_id``, ``budget >= 0``.  Partner ids past the last body are not
    checked here (that would wait on the card): the kernel traps on one,
    as the plain version's gather faults."""
    n = pos.shape[0] if pos.dim() == 2 else -1
    k = nb_idx.shape[1] if nb_idx.dim() == 2 else -1
    device = pos.device
    want = [("pos", pos, (torch.float32,), (n, 3)),
            ("quat", quat, (torch.float32,), (n, 4)),
            ("half", half, (torch.float32,), (n, 3)),
            ("nb_idx", nb_idx, (torch.int32,), (n, k)),
            ("nb_valid", nb_valid, (torch.bool,), (n, k)),
            ("ground_valid", ground_valid, (torch.bool,), (n,))]
    if orig_id is not None:
        want.append(("orig_id", orig_id, (torch.int32, torch.int64), (n,)))
    for name, t, dtypes, shape in want:
        if (t.device != device or t.dtype not in dtypes
                or tuple(t.shape) != shape):
            raise ValueError(
                f"box_contacts: {name} must be "
                f"{'/'.join(map(str, dtypes))}{list(shape)} on {device}, "
                f"got {t.dtype}{list(t.shape)} on {t.device}")
    if k < 1:
        raise ValueError(f"box_contacts: the kernel takes at least 1 "
                         f"partner slot a body, got K={k}")
    if budget < 0:
        raise ValueError(f"box_contacts: budget must be >= 0, got {budget}")
    if device.type != "cuda":
        raise ValueError(f"box_contacts: the kernel runs on CUDA tensors, "
                         f"got {device}")


def _rows(t: Tensor) -> Tensor:
    """``t`` with unit column stride (the kernel takes any row stride, so
    the packed rows of the all-pairs route are read in place)."""
    return t if t.stride(1) == 1 else t.contiguous()


def box_contacts(pos: Tensor, quat: Tensor, half: Tensor, nb_idx: Tensor,
                 nb_valid: Tensor, ground_valid: Tensor, budget: int = 12,
                 orig_id: Tensor | None = None):
    """:func:`contact_t.box_contacts_t_reference` of a box-only call, by
    the CUDA kernel on the current stream: (c_prt, c_ptx, c_pty, c_ptz,
    c_nx, c_ny, c_nz, c_dep, c_valid, overflow), each [budget, N], the
    overflow an int32 scalar, then c_feat with ``orig_id``.  Invalid
    inputs raise ValueError (:func:`check_inputs`)."""
    check_inputs(pos, quat, half, nb_idx, nb_valid, ground_valid, budget,
                 orig_id)
    n, k = nb_idx.shape
    device = pos.device
    pos, quat, half = _rows(pos), _rows(quat), _rows(half)
    nb_idx, nb_valid = nb_idx.contiguous(), nb_valid.contiguous()
    ground_valid = ground_valid.contiguous()
    want_feat = orig_id is not None
    if want_feat:
        orig_id = orig_id.contiguous()
    floats = torch.empty((7, budget, n), dtype=torch.float32, device=device)
    ints = torch.empty((2 if want_feat else 1, budget, n), dtype=torch.int32,
                       device=device)
    valid = torch.empty((budget, n), dtype=torch.bool, device=device)
    overflow = torch.empty((), dtype=torch.int32, device=device)
    KERNEL.launch(
        device, pos.data_ptr(), pos.stride(0), quat.data_ptr(),
        quat.stride(0), half.data_ptr(), half.stride(0), nb_idx.data_ptr(),
        nb_valid.data_ptr(), ground_valid.data_ptr(),
        orig_id.data_ptr() if want_feat else None,
        orig_id.element_size() if want_feat else 0, n, k, budget,
        ints[0].data_ptr(), floats.data_ptr(), valid.data_ptr(),
        ints[1].data_ptr() if want_feat else None, overflow.data_ptr())
    out = (ints[0], *floats.unbind(0), valid, overflow)
    return out + (ints[1],) if want_feat else out


def box_contacts_reference(*args, **kwargs):
    """Plain PyTorch version of :func:`box_contacts`, on any device:
    :func:`contact_t.box_contacts_t_reference`."""
    from banggameengine_tpu_torch.physics import contact_t

    return contact_t.box_contacts_t_reference(*args, **kwargs)


_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
KERNEL = cuda_build.HandKernel(
    "contacts", "bge_box_contacts", _SOURCE,
    [_ptr, _i32] * 3 + [_ptr] * 4 + [_i32] * 4 + [_ptr] * 6,
    flags=_EXTRA_FLAGS, wrapper=box_contacts, plain=box_contacts_reference,
    replaces=None)
load_kernel_library = KERNEL.load
