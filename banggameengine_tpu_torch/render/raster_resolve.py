"""Fused visibility walk + attribute resolve: plain version and CUDA kernel.

Counterpart of ``banggameengine_tpu/render/raster_resolve_pallas.py``
:func:`raster_resolve_tiles_pallas`.  The TPU kernel
``_raster_resolve_kernel`` becomes the CUDA kernel in
``csrc/raster_resolve.cu``; :func:`raster_resolve_tiles` launches it for
CUDA tensors and runs the plain PyTorch version,
:func:`raster_resolve_tiles_reference`, for CPU tensors.

The contract is the walk of :mod:`raster_walk` followed by the resolve of
:mod:`resolve` on the walk's winning slots, in one kernel: (depth
f32[tiles, 4096], slot int32[tiles, 4096], resolved f32[C, tiles, 4096]),
with ``resolved`` None when ``tables`` is None (depth and slot only).  The
JAX kernel walks whole chunks of 8 per tile and resolves by a one-hot
product; both give these numbers (the product returns +0.0 where a table
holds -0.0, and needs finite tables: one inf or NaN entry turns its
tile's whole channel to NaN there, while here it reaches only the pixels
that select it).

The kernel runs the walk kernel's banded walk (``csrc/tile_walk.cuh``:
bands of 4 pixel rows, one block each, warps skipping the slots whose
cover boxes miss them) and then writes each band's pixels of every
channel plane, reading the winners' entries straight from the tile's
table, so a table of any width resolves.
"""

from __future__ import annotations

import ctypes
import os

import torch

from banggameengine_tpu_torch import cuda_build
from banggameengine_tpu_torch.render import raster_walk as rwk
from banggameengine_tpu_torch.render import resolve as rsv
from banggameengine_tpu_torch.render.raster_walk import TILE_PX

Tensor = torch.Tensor

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                       "raster_resolve.cu")
# uncontracted f32 arithmetic, as PyTorch's eager ops round it
_EXTRA_FLAGS = ("--fmad=false",)


def raster_resolve_tiles_reference(counts: Tensor, tri_pack: Tensor,
                                   tables: Tensor | None, tiles_x: int):
    """Plain PyTorch version of :func:`raster_resolve_tiles`, on any
    device: the plain walk, then the plain resolve of its slots."""
    depth, slot = rwk.raster_walk_reference(counts, tri_pack, tiles_x)
    resolved = (None if tables is None
                else rsv.resolve_tiles_wide_reference(slot, tables))
    return depth, slot, resolved


def _check_inputs(counts: Tensor, tri_pack: Tensor,
                  tables: Tensor | None) -> None:
    rwk.check_walk_inputs(counts, tri_pack)
    if tables is None:
        return
    if (tables.dtype != torch.float32 or tables.dim() != 3
            or tables.shape[0] != tri_pack.shape[0] or tables.shape[1] < 1
            or tables.shape[2] < 1 or tables.device != tri_pack.device):
        raise ValueError(f"raster_resolve_tiles: tables must be f32"
                         f"[{tri_pack.shape[0]}, C, KL] on "
                         f"{tri_pack.device}, got {tables.dtype}"
                         f"{list(tables.shape)} on {tables.device}")


def cuda_raster_resolve_tiles(counts: Tensor, tri_pack: Tensor,
                              tables: Tensor | None, tiles_x: int):
    """The CUDA kernel on the current stream."""
    _check_inputs(counts, tri_pack, tables)
    n_tiles, k_pad, _ = tri_pack.shape
    c, kl = (0, 0) if tables is None else tables.shape[1:]
    device = tri_pack.device
    counts, tri_pack = counts.contiguous(), tri_pack.contiguous()
    depth = torch.empty((n_tiles, TILE_PX), dtype=torch.float32,
                        device=device)
    slot = torch.empty((n_tiles, TILE_PX), dtype=torch.int32, device=device)
    resolved = None
    if tables is not None:
        tables = tables.contiguous()
        resolved = torch.empty((c, n_tiles, TILE_PX), dtype=torch.float32,
                               device=device)
    KERNEL.launch(
        device, counts.data_ptr(), tri_pack.data_ptr(), n_tiles, k_pad,
        tiles_x, None if tables is None else tables.data_ptr(), c, kl,
        depth.data_ptr(), slot.data_ptr(),
        None if resolved is None else resolved.data_ptr())
    return depth, slot, resolved


def raster_resolve_tiles(counts: Tensor, tri_pack: Tensor,
                         tables: Tensor | None, tiles_x: int):
    """Walk every tile to its count and resolve the winners through the
    per-tile tables f32[tiles, C, KL] -> (depth f32[tiles, 4096], slot
    int32[tiles, 4096], resolved f32[C, tiles, 4096] or None).

    CUDA tensors always go through the CUDA kernel; CPU tensors through
    the plain version; any other device raises."""
    if tri_pack.device.type == "cuda":
        return cuda_raster_resolve_tiles(counts, tri_pack, tables, tiles_x)
    if tri_pack.device.type == "cpu":
        _check_inputs(counts, tri_pack, tables)
        return raster_resolve_tiles_reference(counts, tri_pack, tables,
                                              tiles_x)
    raise NotImplementedError(
        f"raster_resolve_tiles: no kernel for device {tri_pack.device}")


_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
KERNEL = cuda_build.HandKernel(
    "fused", "bge_raster_resolve", _SOURCE,
    [_ptr, _ptr, _i32, _i32, _i32, _ptr, _i32, _i32, _ptr, _ptr, _ptr, _ptr],
    flags=_EXTRA_FLAGS, wrapper=raster_resolve_tiles,
    plain=raster_resolve_tiles_reference,
    replaces="banggameengine_tpu/render/raster_resolve_pallas.py:68")
load_kernel_library = KERNEL.load
