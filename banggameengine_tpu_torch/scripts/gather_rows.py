"""Row gather of a u8 table: plain version and CUDA kernel.

Counterpart of the Pallas probe ``pl_gather`` of the JAX repository's
``scripts/profile_shade_parts.py``.  Its TPU kernel ``gather_kernel``
becomes the CUDA kernel in ``csrc/gather_rows.cu``; :func:`gather_rows_u8`
launches it for CUDA tensors and runs the plain PyTorch version,
:func:`gather_rows_u8_reference`, for CPU tensors.

The contract is the kernel body's ``jnp.take(table, idx, axis=0)`` in its
default mode: an index in ``[-R, R)`` selects row ``idx`` if it is >= 0 and
row ``R + idx`` if it is negative; any other index gives 255 in every byte
of its row.
"""

from __future__ import annotations

import ctypes
import os

import torch

from banggameengine_tpu_torch import cuda_build

Tensor = torch.Tensor

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                       "gather_rows.cu")


def gather_rows_u8_reference(table: Tensor, idx: Tensor) -> Tensor:
    """Plain PyTorch version of :func:`gather_rows_u8`, on any device."""
    r = table.shape[0]
    ok = (idx >= -r) & (idx < r)
    row = torch.where(ok, torch.where(idx < 0, idx + r, idx), 0)
    rows = table.index_select(0, row.to(torch.int64))
    return torch.where(ok[:, None], rows, 255)


def _check_inputs(table: Tensor, idx: Tensor) -> None:
    if (table.dtype != torch.uint8 or table.dim() != 2 or table.shape[0] < 1
            or table.shape[1] < 1 or table.shape[0] >= 2**31):
        raise ValueError(f"gather_rows_u8: table must be uint8[R, W] with "
                         f"1 <= R < 2**31, W >= 1, got "
                         f"{table.dtype}{list(table.shape)}")
    if (idx.dtype != torch.int32 or idx.dim() != 1 or idx.shape[0] < 1
            or idx.device != table.device):
        raise ValueError(f"gather_rows_u8: idx must be int32[P >= 1] on "
                         f"{table.device}, got {idx.dtype}{list(idx.shape)} "
                         f"on {idx.device}")


def cuda_gather_rows_u8(table: Tensor, idx: Tensor) -> Tensor:
    """The CUDA kernel on the current stream."""
    _check_inputs(table, idx)
    r, w = table.shape
    p = idx.shape[0]
    table, idx = table.contiguous(), idx.contiguous()
    out = torch.empty((p, w), dtype=torch.uint8, device=table.device)
    KERNEL.launch(table.device, table.data_ptr(), idx.data_ptr(), p, r, w,
                  out.data_ptr())
    return out


def gather_rows_u8(table: Tensor, idx: Tensor) -> Tensor:
    """Gather rows of ``table`` uint8[R, W] at ``idx`` int32[P] ->
    uint8[P, W] (255 for an index outside ``[-R, R)``).

    CUDA tensors always go through the CUDA kernel; CPU tensors through
    the plain version; any other device raises."""
    if table.device.type == "cuda":
        return cuda_gather_rows_u8(table, idx)
    if table.device.type == "cpu":
        _check_inputs(table, idx)
        return gather_rows_u8_reference(table, idx)
    raise NotImplementedError(
        f"gather_rows_u8: no kernel for device {table.device}")


_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
KERNEL = cuda_build.HandKernel(
    "gather", "bge_gather_rows", _SOURCE,
    [_ptr, _ptr, ctypes.c_longlong, _i32, _i32, _ptr, _ptr],
    wrapper=gather_rows_u8, plain=gather_rows_u8_reference,
    replaces="scripts/profile_shade_parts.py:93")
load_kernel_library = KERNEL.load
