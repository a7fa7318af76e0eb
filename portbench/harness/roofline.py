"""The least time the card could take for a kernel's work.

The published H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W
limit) and the work of three hand kernels, counted from each call's
inputs as what those inputs need.  Frozen copies of the port's
``utils/profiling.bound_ms`` and of ``chip_smoke.py``'s
``broadphase_bound``, ``walk_bound``, ``walk_skip_share`` and
``resolve_bound``, computed with the reference's plain helpers, so that a
change to a kernel is held to the same work.
"""

from __future__ import annotations

import torch

from portbench.reference.physics import broadphase_kernel as bk
from portbench.reference.render import raster_walk as rwk

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# operations per (row, column) pair of the broadphase: 6 float compares,
# 8 integer tests of solidity, layer and mask, j != i, 10 ands
BROADPHASE_OPS = 25
# the union pre-pass: per body the margins (6) and its 6 bounds into its
# band's and its group's unions (24); per (band, group) pair 6 compares
# and 5 ands
UNION_BODY_OPS, UNION_PAIR_OPS = 30, 11
# f32 operations per (pixel, used slot) of the walk: edge functions 15,
# coverage compares 6, barycentric weights 4, depth 5, depth tests 3
RASTER_OPS = 33
WALK_WARP_ROWS = 4   # a walk warp's pixels: 32 x kRows of raster_walk.cu


def bound_ms(n_bytes: float, ops: float) -> float:
    """The larger of ``n_bytes`` over the memory rate and ``ops`` f32
    operations over the peak rate, in ms."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3


def broadphase_bound(mn, mx, max_neighbors: int) -> float:
    """Kernel #1 on sorted AABBs ``mn``, ``mx`` f32[N, 3] (no margin):
    each box, flag, layer and mask read once, K + 1 ints a row written,
    the union pre-pass and the pair tests of the (band, group) pairs the
    unions keep."""
    n = mn.shape[0]
    kept = bk.band_group_kept(*bk.with_margin(mn, mx))
    ops = (UNION_BODY_OPS * n + UNION_PAIR_OPS * kept.numel()
           + BROADPHASE_OPS * int(kept.sum()) * bk.BAND_ROWS
           * bk.GROUP_COLS)
    return bound_ms(36 * n + 4 * (max_neighbors + 1) * n, ops)


def walk_skip_share(counts, pack, tiles_x: int,
                    rows: int = WALK_WARP_ROWS) -> float:
    """The share of (warp footprint, walked used slot) pairs whose cover
    box misses the footprint of 32 x ``rows`` pixels."""
    box = rwk.cover_boxes(pack)                        # [tiles, K, 4]
    t = torch.arange(pack.shape[0], device=pack.device)[:, None, None]
    wx0 = (t % tiles_x) * 128 + torch.arange(0, 128, 32,
                                             device=pack.device) + 0.5
    wy0 = (t // tiles_x) * 32 + torch.arange(0, 32, rows,
                                             device=pack.device) + 0.5
    miss_x = (wx0 + 31 < box[..., 0:1]) | (wx0 > box[..., 1:2])
    miss_y = (wy0 + rows - 1 < box[..., 2:3]) | (wy0 > box[..., 3:4])
    miss = miss_x[..., :, None] | miss_y[..., None, :]
    walked = ((torch.arange(pack.shape[1], device=pack.device)[None]
               < counts[:, None]) & (pack[..., 9] > 0))
    return float(miss[walked].float().mean()) if walked.any() else 1.0


def walk_bound(counts, pack, tiles_x: int) -> float:
    """Kernel #3 on one frame's binned triangles: the counts, the walked
    rows and the two output planes; the operations of the (pixel, used
    slot) pairs in the (warp, slot) pairs its cover boxes keep."""
    k_pad = pack.shape[1]
    in_count = (torch.arange(k_pad, device=pack.device)[None, :]
                < counts[:, None])
    walked = int(in_count.sum())
    used = int((in_count & (pack[..., 9] > 0)).sum())
    n = pack.shape[0]
    kept = 1.0 - walk_skip_share(counts, pack, tiles_x)
    return bound_ms(4 * n + 40 * walked + 8 * n * 4096,
                    RASTER_OPS * used * 4096 * kept)


def resolve_bound(slot, table) -> float:
    """Kernel #2 on one frame's slots and tables: each read once, the
    resolved planes written once."""
    n, c, kl = table.shape
    return bound_ms(
        4 * slot.numel() + 4 * n * c * kl + 4 * c * slot.numel(), 0)
