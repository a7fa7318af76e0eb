"""Tiled visibility walk: packed per-tile triangle rows, plain version and
CUDA kernel.

Counterpart of ``banggameengine_tpu/render/raster_resolve_pallas.py``
:func:`pack_tile_triangles` and :func:`raster_walk_pallas`.  The TPU
kernel ``_walk_kernel`` becomes the CUDA kernel in
``csrc/raster_walk.cu``; :func:`raster_walk` launches it for CUDA tensors
and runs the plain PyTorch version, :func:`raster_walk_reference`, for CPU
tensors.

The contract: for each 32x128-pixel tile, walk slots ``0 .. counts[t]-1``
of its packed rows and keep, per pixel, the nearest covering sub-triangle
(two-sided edge functions, NDC depth in [0, 1]).  The winner is the lowest
slot that reaches the minimum depth.  Output: depth f32[tiles, 4096] (1.0
where no slot covers) and slot int32[tiles, 4096] (-1 there).  Slots at or
beyond a tile's count are ignored; the JAX kernel walks whole chunks up to
its block's largest count, which gives the same result because the
binner's padding rows there have ``ok = 0``.

The kernel splits each tile's 32 pixel rows into bands of 4 rows, one
block each, so the densest tiles spread over many SMs, and each warp
skips the slots whose cover box (the region outside which a slot provably
covers no pixel centre) misses its 32 x 4 pixels; every pixel still walks
the slots that can cover it in ascending order.  That banded walk lives
once, in ``csrc/tile_walk.cuh``, and the fused walk + resolve and the
full-carry raster run it too.  :func:`cover_boxes` is the plain version
of those boxes, for the tests and reports; the kernels' path does not
call it.
"""

from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from banggameengine_tpu_torch import cuda_build

Tensor = torch.Tensor

TILE_H = 32
TILE_W = 128
TILE_PX = TILE_H * TILE_W
# packed per-tile triangle rows (channel index in the last dim)
ROW_X0, ROW_X1, ROW_X2 = 0, 1, 2
ROW_Y0, ROW_Y1, ROW_Y2 = 3, 4, 5
ROW_Z0, ROW_Z1, ROW_Z2 = 6, 7, 8
ROW_OK = 9
PACK_CH = 16
PLAIN_CHUNK = 8   # slots per step of the plain versions

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                       "raster_walk.cu")
# uncontracted f32 arithmetic, as PyTorch's eager ops round it
_EXTRA_FLAGS = ("--fmad=false",)


def pack_tile_triangles(sel_ids: Tensor, sx: Tensor, sy: Tensor, z: Tensor,
                        chunk: int = 8) -> tuple[Tensor, int]:
    """Per-tile triangle rows for the walk.

    sel_ids int32[tiles, K] binned sub-triangle ids (-1 empty); sx/sy/z
    f32[S, 3] screen coordinates and NDC depth per sub-triangle ->
    (tri_pack f32[tiles, K_pad, 16], K_pad), K_pad = K rounded up to
    ``chunk``; rows ``ROW_X0..ROW_OK``, the rest zero."""
    n_tiles, k = sel_ids.shape
    k_pad = -(-k // chunk) * chunk
    safe = sel_ids.clamp_min(0).reshape(-1).to(torch.int64)
    rows = torch.cat([sx.T, sy.T, z.T])                  # [9, S]
    g = rows[:, safe].reshape(9, n_tiles, k)
    ok = (sel_ids >= 0).to(torch.float32)
    pack = torch.cat([g, ok[None]], dim=0).permute(1, 2, 0)   # [tiles, K, 10]
    pack = F.pad(pack, (0, PACK_CH - pack.shape[-1], 0, k_pad - k))
    return pack.contiguous(), k_pad


def pixel_centres(tile_ids: Tensor, tiles_x: int) -> tuple[Tensor, Tensor]:
    """Pixel centres (px, py) f32[n, 4096] of the screen tiles ``tile_ids``
    int[n]."""
    t = tile_ids.to(torch.int64)[:, None]
    p = torch.arange(TILE_PX, device=tile_ids.device)[None, :]
    px = ((t % tiles_x) * TILE_W + p % TILE_W).to(torch.float32) + 0.5
    py = ((t // tiles_x) * TILE_H + p // TILE_W).to(torch.float32) + 0.5
    return px, py


def slot_coverage(x0, x1, x2, y0, y1, y2, z0, z1, z2, pxc: Tensor,
                  pyc: Tensor):
    """Slots' corners against pixel centres, broadcast, in the kernels' op
    order -> (cover, w0, w1, w2, depth): ``cover`` where the three edge
    functions agree in sign with the area (two-sided) and the depth
    ``w0*z0 + w1*z1 + w2*z2`` lies in [0, 1]."""
    e0 = (x1 - x0) * (pyc - y0) - (y1 - y0) * (pxc - x0)
    e1 = (x2 - x1) * (pyc - y1) - (y2 - y1) * (pxc - x1)
    e2 = (x0 - x2) * (pyc - y2) - (y0 - y2) * (pxc - x2)
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    pos = (e0 >= 0) & (e1 >= 0) & (e2 >= 0)
    neg = (e0 <= 0) & (e1 <= 0) & (e2 <= 0)
    apos = area > 0
    inv_area = torch.reciprocal(torch.where(area.abs() > 1e-9, area, 1e-9))
    w1 = e2 * inv_area
    w2 = e0 * inv_area
    w0 = 1.0 - w1 - w2
    depth = w0 * z0 + w1 * z1 + w2 * z2
    cover = (pos & apos) | (neg & ~apos)
    return cover & (depth >= 0.0) & (depth <= 1.0), w0, w1, w2, depth


# the cover box's bound (csrc/tile_walk.cuh): twice the edge functions'
# rounding error per unit, and the corners and areas it holds for
COVER_ERR = 2.0 ** -21
COVER_MAX_COORD = 1e7
COVER_MIN_AREA = 1e-6


def cover_boxes(tri_pack: Tensor) -> Tensor:
    """f32[tiles, K, 4] (x lo, x hi, y lo, y hi) per packed row, as the
    kernel computes them: the corners' bounding box grown by 2 q R + 1
    pixels and rounded outward, where no pixel centre outside is covered;
    the whole plane for a row the bound does not hold for, an empty box
    for an unused row (``ok <= 0``)."""
    r = tri_pack[..., :6].double()
    x, y = r[..., 0:3], r[..., 3:6]
    xmin, xmax = x.amin(-1), x.amax(-1)
    ymin, ymax = y.amin(-1), y.amax(-1)
    x0, x1, x2, y0, y1, y2 = r.unbind(-1)
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    p = ((x1 - x0).abs() + (y1 - y0).abs() + (x2 - x1).abs()
         + (y2 - y1).abs() + (x0 - x2).abs() + (y0 - y2).abs())
    w = torch.maximum(xmax - xmin, ymax - ymin)
    q = COVER_ERR * p * w / area.abs()
    bounded = ((torch.maximum(torch.maximum(-xmin, xmax),
                              torch.maximum(-ymin, ymax)) <= COVER_MAX_COORD)
               & (area.abs() >= COVER_MIN_AREA) & (q < 0.25))
    m = 2.0 * q * w + 1.0
    inf = float("inf")

    def outward(v, down):
        f = v.float()
        off = f.double() > v if down else f.double() < v
        return torch.where(off, torch.nextafter(
            f, torch.full_like(f, -inf if down else inf)), f)

    box = torch.stack([outward(xmin - m, True), outward(xmax + m, False),
                       outward(ymin - m, True), outward(ymax + m, False)], -1)
    box = torch.where(bounded[..., None], box,
                      box.new_tensor([-inf, inf, -inf, inf]))
    used = tri_pack[..., ROW_OK] > 0.0
    return torch.where(used[..., None], box,
                       box.new_tensor([inf, -inf, inf, -inf]))


def raster_walk_reference(counts: Tensor, tri_pack: Tensor,
                          tiles_x: int) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version of :func:`raster_walk`, on any device.

    Walks all slots in chunks of 8, masked by each tile's count: within a
    chunk the first minimum wins, across chunks only a strictly nearer
    one, as in the JAX kernel."""
    n_tiles, k_pad, _ = tri_pack.shape
    device = tri_pack.device
    px, py = pixel_centres(torch.arange(n_tiles, device=device), tiles_x)
    pxc, pyc = px[:, None, :], py[:, None, :]             # [tiles, 1, px]
    walked = counts.to(torch.int64)[:, None, None]
    zbuf = torch.full((n_tiles, TILE_PX), float("inf"), device=device)
    slotb = torch.full((n_tiles, TILE_PX), -1, dtype=torch.int64,
                       device=device)
    for base in range(0, k_pad, PLAIN_CHUNK):
        rows = tri_pack[:, base:base + PLAIN_CHUNK, :]   # [tiles, c, 16]
        c = rows.shape[1]
        x0, x1, x2, y0, y1, y2, z0, z1, z2, okc = (
            rows[:, :, j, None] for j in range(ROW_OK + 1))
        cover, _, _, _, depth = slot_coverage(x0, x1, x2, y0, y1, y2, z0,
                                              z1, z2, pxc, pyc)
        cidx = torch.arange(c, device=device)[None, :, None]
        in_count = (base + cidx) < walked
        ok = cover & (okc > 0.0) & in_count
        depth = torch.where(ok, depth, float("inf"))
        d_best = depth.amin(dim=1)                         # [tiles, px]
        best = torch.where(depth == d_best[:, None], cidx, c).amin(dim=1)
        better = d_best < zbuf
        zbuf = torch.where(better, d_best, zbuf)
        slotb = torch.where(better, base + best, slotb)
    depth = torch.where(torch.isfinite(zbuf), zbuf, 1.0)
    return depth, slotb.to(torch.int32)


def check_walk_inputs(counts: Tensor, tri_pack: Tensor) -> None:
    if (tri_pack.dtype != torch.float32 or tri_pack.dim() != 3
            or tri_pack.shape[0] < 1 or tri_pack.shape[2] != PACK_CH):
        raise ValueError(f"raster_walk: tri_pack must be f32[tiles >= 1, "
                         f"K_pad, {PACK_CH}], got {tri_pack.dtype}"
                         f"{list(tri_pack.shape)}")
    if (counts.dtype != torch.int32
            or tuple(counts.shape) != (tri_pack.shape[0],)
            or counts.device != tri_pack.device):
        raise ValueError(f"raster_walk: counts must be int32"
                         f"[{tri_pack.shape[0]}] on {tri_pack.device}, got "
                         f"{counts.dtype}{list(counts.shape)} on "
                         f"{counts.device}")


def cuda_raster_walk(counts: Tensor, tri_pack: Tensor,
                     tiles_x: int) -> tuple[Tensor, Tensor]:
    """The CUDA kernel on the current stream."""
    check_walk_inputs(counts, tri_pack)
    n_tiles, k_pad, _ = tri_pack.shape
    device = tri_pack.device
    counts, tri_pack = counts.contiguous(), tri_pack.contiguous()
    depth = torch.empty((n_tiles, TILE_PX), dtype=torch.float32,
                        device=device)
    slot = torch.empty((n_tiles, TILE_PX), dtype=torch.int32, device=device)
    KERNEL.launch(device, counts.data_ptr(), tri_pack.data_ptr(), n_tiles,
                  k_pad, tiles_x, depth.data_ptr(), slot.data_ptr())
    return depth, slot


def raster_walk(counts: Tensor, tri_pack: Tensor,
                tiles_x: int) -> tuple[Tensor, Tensor]:
    """Visibility walk -> (depth f32[tiles, 4096], slot int32[tiles, 4096]).

    CUDA tensors always go through the CUDA kernel; CPU tensors through
    the plain version; any other device raises."""
    if tri_pack.device.type == "cuda":
        return cuda_raster_walk(counts, tri_pack, tiles_x)
    if tri_pack.device.type == "cpu":
        check_walk_inputs(counts, tri_pack)
        return raster_walk_reference(counts, tri_pack, tiles_x)
    raise NotImplementedError(
        f"raster_walk: no kernel for device {tri_pack.device}")


_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
KERNEL = cuda_build.HandKernel(
    "walk", "bge_raster_walk", _SOURCE,
    [_ptr, _ptr, _i32, _i32, _i32, _ptr, _ptr, _ptr], flags=_EXTRA_FLAGS,
    wrapper=raster_walk, plain=raster_walk_reference,
    replaces="banggameengine_tpu/render/raster_resolve_pallas.py:291")
load_kernel_library = KERNEL.load
