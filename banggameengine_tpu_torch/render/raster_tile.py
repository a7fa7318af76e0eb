"""Full-carry tile raster: plain version and CUDA kernel.

Counterpart of ``banggameengine_tpu/render/raster_pallas.py``
:func:`raster_tiles_pallas`, whose spec is the full-carry
``raster._raster_tile``.  The TPU kernel ``_tile_kernel`` becomes the CUDA
kernel in ``csrc/raster_tile.cu``; :func:`raster_tiles` launches it for
CUDA tensors and runs the plain PyTorch version,
:func:`raster_tiles_reference`, for CPU tensors.

The contract: for each listed screen tile ``tile_idx[i]`` (32x128 pixels)
walk all K slots of its gathered rows in slot order and keep, per pixel,
the nearest covering sub-triangle (two-sided edge functions, NDC depth in
[0, 1]); the winner is the lowest slot that reaches the minimum depth.
Five planes come back, each ``[n, 32, 128]``: depth f32 (1.0 where no slot
covers), the winner's original triangle id int32 (-1), its original-space
barycentrics b1 and b2 f32 (0), and its slot int32 (-1).  ``b1`` is
``w0 * cb1[0] + w1 * cb1[1] + w2 * cb1[2]`` of the winner's sub-triangle
weights and corner columns, and likewise ``b2``.

The kernel walks with the walk kernel's banded walk
(``csrc/tile_walk.cuh``: bands of 4 pixel rows, one block each, warps
skipping the slots whose cover boxes miss them), carrying depth and slot
only; each covered pixel then recomputes its winner's weights from the
winner's row, which gives the weights its winning test computed, bit for
bit.  :func:`raster_walk.cover_boxes` of :func:`kernel_cases.carry_pack`
is the plain version of the boxes it skips by.
"""

from __future__ import annotations

import ctypes
import os

import torch

from banggameengine_tpu_torch import cuda_build
from banggameengine_tpu_torch.render import raster_walk as rwk
from banggameengine_tpu_torch.render.raster_walk import (
    PLAIN_CHUNK,
    TILE_H,
    TILE_PX,
    TILE_W,
    pixel_centres,
)

Tensor = torch.Tensor

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                       "raster_tile.cu")
# uncontracted f32 arithmetic, as PyTorch's eager ops round it
_EXTRA_FLAGS = ("--fmad=false",)


def raster_tiles_reference(tile_idx: Tensor, x: Tensor, y: Tensor, z: Tensor,
                           oid: Tensor, cb1: Tensor, cb2: Tensor, ok: Tensor,
                           tiles_x: int):
    """Plain PyTorch version of :func:`raster_tiles`, on any device.

    Walks the slots in chunks of 8: within a chunk the first minimum wins,
    across chunks only a strictly nearer one."""
    n, k = ok.shape
    device = x.device
    px, py = pixel_centres(tile_idx, tiles_x)
    pxc, pyc = px[:, None, :], py[:, None, :]             # [n, 1, px]
    zbuf = torch.full((n, TILE_PX), float("inf"), device=device)
    tri = torch.full((n, TILE_PX), -1, dtype=torch.int32, device=device)
    b1b = torch.zeros((n, TILE_PX), device=device)
    b2b = torch.zeros((n, TILE_PX), device=device)
    slotb = torch.full((n, TILE_PX), -1, dtype=torch.int32, device=device)
    for base in range(0, k, PLAIN_CHUNK):
        sl = slice(base, base + PLAIN_CHUNK)
        x0, x1, x2 = (x[:, sl, j, None] for j in range(3))   # [n, c, 1]
        y0, y1, y2 = (y[:, sl, j, None] for j in range(3))
        z0, z1, z2 = (z[:, sl, j, None] for j in range(3))
        c = x0.shape[1]
        cover, w0, w1, w2, depth = rwk.slot_coverage(x0, x1, x2, y0, y1, y2,
                                                     z0, z1, z2, pxc, pyc)
        depth = torch.where(cover & (ok[:, sl, None] != 0), depth,
                            float("inf"))                  # [n, c, px]
        d_best = depth.amin(dim=1)                          # [n, px]
        cidx = torch.arange(c, device=device)[None, :, None]
        best = torch.where(depth == d_best[:, None], cidx, c).amin(dim=1)
        better = d_best < zbuf
        pick = best.clamp_max(c - 1)[:, None]               # [n, 1, px]

        def winner(cb):
            ob = (w0 * cb[:, sl, 0, None] + w1 * cb[:, sl, 1, None]
                  + w2 * cb[:, sl, 2, None])
            return torch.gather(ob, 1, pick)[:, 0]

        zbuf = torch.where(better, d_best, zbuf)
        tri = torch.where(better, torch.gather(oid[:, sl], 1, pick[:, 0]),
                          tri)
        b1b = torch.where(better, winner(cb1), b1b)
        b2b = torch.where(better, winner(cb2), b2b)
        slotb = torch.where(better, (base + best).to(torch.int32), slotb)
    depth = torch.where(torch.isfinite(zbuf), zbuf, 1.0)
    return tuple(a.reshape(n, TILE_H, TILE_W)
                 for a in (depth, tri, b1b, b2b, slotb))


def _check_inputs(tile_idx, x, y, z, oid, cb1, cb2, ok) -> None:
    if (ok.dtype != torch.int32 or ok.dim() != 2 or ok.shape[0] < 1):
        raise ValueError(f"raster_tiles: ok must be int32[n >= 1, K], got "
                         f"{ok.dtype}{list(ok.shape)}")
    n, k = ok.shape
    device = ok.device
    want = [("tile_idx", tile_idx, torch.int32, (n,)),
            ("oid", oid, torch.int32, (n, k))]
    want += [(name, a, torch.float32, (n, k, 3)) for name, a in
             (("x", x), ("y", y), ("z", z), ("cb1", cb1), ("cb2", cb2))]
    for name, a, dtype, shape in want:
        if a.dtype != dtype or tuple(a.shape) != shape or a.device != device:
            raise ValueError(f"raster_tiles: {name} must be {dtype}"
                             f"{list(shape)} on {device}, got {a.dtype}"
                             f"{list(a.shape)} on {a.device}")


def cuda_raster_tiles(tile_idx: Tensor, x: Tensor, y: Tensor, z: Tensor,
                      oid: Tensor, cb1: Tensor, cb2: Tensor, ok: Tensor,
                      tiles_x: int):
    """The CUDA kernel on the current stream."""
    _check_inputs(tile_idx, x, y, z, oid, cb1, cb2, ok)
    n, k = ok.shape
    device = ok.device
    ins = [a.contiguous() for a in (tile_idx, x, y, z, oid, cb1, cb2, ok)]
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    outs = (torch.empty((n, TILE_H, TILE_W), **f32),
            torch.empty((n, TILE_H, TILE_W), **i32),
            torch.empty((n, TILE_H, TILE_W), **f32),
            torch.empty((n, TILE_H, TILE_W), **f32),
            torch.empty((n, TILE_H, TILE_W), **i32))
    KERNEL.launch(device, *(a.data_ptr() for a in ins), n, k, tiles_x,
                  *(a.data_ptr() for a in outs))
    return outs


def raster_tiles(tile_idx: Tensor, x: Tensor, y: Tensor, z: Tensor,
                 oid: Tensor, cb1: Tensor, cb2: Tensor, ok: Tensor,
                 tiles_x: int):
    """Full-carry raster of the listed tiles -> (depth, tri_id, b1, b2,
    slot), each ``[n, 32, 128]``.

    CUDA tensors always go through the CUDA kernel; CPU tensors through
    the plain version; any other device raises."""
    if ok.device.type == "cuda":
        return cuda_raster_tiles(tile_idx, x, y, z, oid, cb1, cb2, ok,
                                 tiles_x)
    if ok.device.type == "cpu":
        _check_inputs(tile_idx, x, y, z, oid, cb1, cb2, ok)
        return raster_tiles_reference(tile_idx, x, y, z, oid, cb1, cb2, ok,
                                      tiles_x)
    raise NotImplementedError(
        f"raster_tiles: no kernel for device {ok.device}")


_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
KERNEL = cuda_build.HandKernel(
    "tile", "bge_raster_tile", _SOURCE,
    [_ptr] * 8 + [_i32, _i32, _i32] + [_ptr] * 6, flags=_EXTRA_FLAGS,
    wrapper=raster_tiles, plain=raster_tiles_reference,
    replaces="banggameengine_tpu/render/raster_pallas.py:27")
load_kernel_library = KERNEL.load
