"""Per-tile attribute resolve: plain version and CUDA kernel.

Counterpart of ``banggameengine_tpu/render/resolve_pallas.py``
:func:`resolve_tiles_pallas_wide`.  The TPU kernel
``_resolve_wide_kernel`` becomes the CUDA kernel in
``csrc/resolve_wide.cu``; :func:`resolve_tiles_wide` launches it for CUDA
tensors and runs the plain PyTorch version,
:func:`resolve_tiles_wide_reference`, for CPU tensors.

The contract: ``out[c, t, p] = table[t, c, slot[t, p]]`` where
``0 <= slot < KL``, else 0, channel-planar ``f32[C, tiles, px]``.  The JAX
kernel computes it as a one-hot matrix product, which equals this gather
only for finite tables (``0 * inf`` is NaN in the product), and returns
+0.0 where the gather returns a table's -0.0; ``torch.equal`` and
``numpy.array_equal`` count the two zeros equal.  The JAX kernel's
``max_slot`` argument only lets it skip work; the gather needs none.
"""

from __future__ import annotations

import ctypes
import os

import torch

from banggameengine_tpu_torch import cuda_build

Tensor = torch.Tensor

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                       "resolve_wide.cu")


def resolve_tiles_wide_reference(slot: Tensor, table: Tensor) -> Tensor:
    """Plain PyTorch version of :func:`resolve_tiles_wide`, on any device."""
    n_tiles, px = slot.shape
    c, kl = table.shape[1], table.shape[2]
    valid = (slot >= 0) & (slot < kl)
    idx = torch.where(valid, slot, 0).to(torch.int64)
    g = torch.gather(table, 2, idx[:, None, :].expand(n_tiles, c, px))
    return torch.where(valid[None], g.permute(1, 0, 2), 0.0).contiguous()


def _check_inputs(slot: Tensor, table: Tensor) -> None:
    if (slot.dtype != torch.int32 or slot.dim() != 2 or slot.shape[0] < 1
            or slot.shape[1] < 1):
        raise ValueError(f"resolve_tiles_wide: slot must be int32[tiles, px],"
                         f" got {slot.dtype}{list(slot.shape)}")
    if (table.dtype != torch.float32 or table.dim() != 3
            or table.shape[0] != slot.shape[0] or table.shape[1] < 1
            or table.shape[2] < 1 or table.device != slot.device):
        raise ValueError(f"resolve_tiles_wide: table must be f32"
                         f"[{slot.shape[0]}, C, KL] on {slot.device}, got "
                         f"{table.dtype}{list(table.shape)} on "
                         f"{table.device}")


def cuda_resolve_tiles_wide(slot: Tensor, table: Tensor) -> Tensor:
    """The CUDA kernel on the current stream."""
    _check_inputs(slot, table)
    n_tiles, px = slot.shape
    c, kl = table.shape[1], table.shape[2]
    slot, table = slot.contiguous(), table.contiguous()
    out = torch.empty((c, n_tiles, px), dtype=torch.float32,
                      device=slot.device)
    KERNEL.launch(slot.device, slot.data_ptr(), table.data_ptr(), n_tiles,
                  px, c, kl, out.data_ptr())
    return out


def resolve_tiles_wide(slot: Tensor, table: Tensor) -> Tensor:
    """Resolve ``slot`` int32[tiles, px] (-1 background) through the
    per-tile tables f32[tiles, C, KL] -> f32[C, tiles, px].

    CUDA tensors always go through the CUDA kernel; CPU tensors through
    the plain version; any other device raises."""
    if slot.device.type == "cuda":
        return cuda_resolve_tiles_wide(slot, table)
    if slot.device.type == "cpu":
        _check_inputs(slot, table)
        return resolve_tiles_wide_reference(slot, table)
    raise NotImplementedError(
        f"resolve_tiles_wide: no kernel for device {slot.device}")


_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
KERNEL = cuda_build.HandKernel(
    "resolve", "bge_resolve_wide", _SOURCE,
    [_ptr, _ptr, _i32, _i32, _i32, _i32, _ptr, _ptr],
    wrapper=resolve_tiles_wide, plain=resolve_tiles_wide_reference,
    replaces="banggameengine_tpu/render/resolve_pallas.py:117")
load_kernel_library = KERNEL.load
