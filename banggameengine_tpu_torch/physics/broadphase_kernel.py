"""All-pairs AABB broadphase: Morton key, plain version and CUDA kernel.

Counterpart of ``banggameengine_tpu/physics/broadphase_pallas.py``.  The
TPU kernel ``_neighbor_kernel`` becomes the CUDA kernel in
``csrc/neighbor_lists.cu``; :func:`neighbor_lists_aabb` (counterpart of
``neighbor_lists_pallas_aabb``) launches it for CUDA tensors and runs the
plain PyTorch version, :func:`neighbor_lists_aabb_reference`, for CPU
tensors.  Both return the JAX package's ``NeighborLists`` contract: for
each row, the first K partners in ascending column order, -1 padded, and
the count of partners dropped beyond K.

The pair filter matches the JAX kernel exactly: AABB overlap with the
margin split across both sides, both solid, at least one dynamic, layer and
mask both ways, not self.

The kernel prunes by block AABBs: it skips every (band of
:data:`BAND_ROWS` rows, group of :data:`GROUP_COLS` columns) pair whose
union boxes do not meet, which changes no result (the argument is in the
kernel's header).  :func:`block_bounds` and :func:`band_group_kept` are
the plain versions of those unions and of that test, for the tests and
for reporting the share of pairs the kernel visits; the kernel's path does
not call them.
"""

from __future__ import annotations

import ctypes
import os

import torch

from banggameengine_tpu_torch import cuda_build
from banggameengine_tpu_torch.physics.broadphase import NeighborLists

Tensor = torch.Tensor

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                       "neighbor_lists.cu")
AABB_MARGIN = 0.04   # split across both sides of every pair test
# rows per chunk of the plain version's [rows, N] mask: 2^24 pair entries
# bound its working set to a few hundred MB at N = 10k
_PLAIN_PAIRS_PER_CHUNK = 1 << 24
# the kernel's pruning granularity (kGroup, kBand in csrc/neighbor_lists.cu;
# the library is checked against them when it loads)
GROUP_COLS = 32
BAND_ROWS = 64


def morton_key_xz(pos: Tensor, cell: float = 0.25) -> Tensor:
    """Morton (z-order) key over the horizontal plane: interleaved 15-bit
    quantized x/z, int32[N].  Sorting bodies by it keeps spatial neighbours
    near each other in the sorted order."""
    mn = pos.min(dim=0).values
    xi = ((pos[:, 0] - mn[0]) / cell).to(torch.int32).clamp(0, 0x7FFF)
    zi = ((pos[:, 2] - mn[2]) / cell).to(torch.int32).clamp(0, 0x7FFF)

    def spread(v):
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    return spread(xi) | (spread(zi) << 1)


def with_margin(mn: Tensor, mx: Tensor):
    """AABBs grown by half the margin on each side, in the same f32
    arithmetic as the JAX wrapper (bit-identical bounds)."""
    return mn - 0.5 * AABB_MARGIN, mx + 0.5 * AABB_MARGIN


def _to_neighbor_lists(idx: Tensor, count: Tensor, k: int) -> NeighborLists:
    overflow = (count - k).clamp_min(0).sum().to(torch.int32)
    return NeighborLists(
        idx=idx, valid=idx >= 0,
        cell_overflow=torch.zeros((), dtype=torch.int32, device=idx.device),
        nbr_overflow=overflow)


def plain_idx_count(lo: Tensor, hi: Tensor, dyn: Tensor, layer: Tensor,
                    mask: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """Plain PyTorch all-pairs filter over row chunks, margins already
    applied: (idx int32[N, k], count int32[N] of all passing columns)."""
    n = lo.shape[0]
    cols = torch.arange(n, dtype=torch.int32, device=lo.device)
    chunk = max(1, _PLAIN_PAIRS_PER_CHUNK // n)
    idx_parts, count_parts = [], []
    for r0 in range(0, n, chunk):
        r = slice(r0, min(n, r0 + chunk))
        ov = cols[r, None] != cols[None, :]
        for ax in range(3):
            ov &= ((lo[r, ax, None] <= hi[None, :, ax])
                   & (lo[None, :, ax] <= hi[r, ax, None]))
        rd, cd = dyn[r, None], dyn[None, :]
        ov &= (rd >= 0) & (cd >= 0) & ((rd > 0) | (cd > 0))
        ov &= (((layer[r, None] & mask[None, :]) != 0)
               & ((layer[None, :] & mask[r, None]) != 0))
        # stable compaction: passing columns keep their order, the rest
        # (key n) sort behind them
        key = torch.where(ov, cols[None, :], n)
        first = torch.sort(key, dim=1, stable=True).values[:, :k]
        idx_parts.append(torch.where(first < n, first, -1))
        count_parts.append(ov.sum(dim=1, dtype=torch.int32))
    idx = torch.cat(idx_parts)
    if idx.shape[1] < k:   # fewer bodies than slots
        idx = torch.nn.functional.pad(idx, (0, k - idx.shape[1]), value=-1)
    return idx, torch.cat(count_parts)


def block_bounds(lo: Tensor, hi: Tensor,
                 group: int) -> tuple[Tensor, Tensor]:
    """Union box of every run of ``group`` consecutive rows of f32[N, 3]
    boxes, NaN bounds left out (+inf / -inf where all of a run's bounds on
    an axis are NaN): (lo f32[ceil(N / group), 3], hi the same), as the
    kernel's union pre-pass computes them."""
    n = lo.shape[0]
    pad = -n % group
    inf = float("inf")
    lo = torch.where(torch.isnan(lo), inf, lo)
    hi = torch.where(torch.isnan(hi), -inf, hi)
    lo = torch.nn.functional.pad(lo, (0, 0, 0, pad), value=inf)
    hi = torch.nn.functional.pad(hi, (0, 0, 0, pad), value=-inf)
    return (lo.reshape(-1, group, 3).amin(dim=1),
            hi.reshape(-1, group, 3).amax(dim=1))


def band_group_kept(lo: Tensor, hi: Tensor) -> Tensor:
    """bool[bands, groups]: the (band of BAND_ROWS rows, group of
    GROUP_COLS columns) pairs whose union boxes meet, margins already
    applied; the kernel visits only these."""
    blo, bhi = block_bounds(lo, hi, BAND_ROWS)
    glo, ghi = block_bounds(lo, hi, GROUP_COLS)
    return ((blo[:, None, :] <= ghi[None, :, :])
            & (glo[None, :, :] <= bhi[:, None, :])).all(dim=2)


def neighbor_lists_aabb_reference(
    mn: Tensor,           # f32[N,3] AABB min (no margin applied yet)
    mx: Tensor,           # f32[N,3] AABB max
    dyn: Tensor,          # int32[N]: -1 not solid, 0 solid static, 1 dynamic
    layer_i: Tensor,      # int32[N]
    mask_i: Tensor,       # int32[N]
    max_neighbors: int = 8,
) -> NeighborLists:
    """Plain PyTorch version of :func:`neighbor_lists_aabb`, on any device."""
    lo, hi = with_margin(mn, mx)
    idx, count = plain_idx_count(lo, hi, dyn, layer_i, mask_i,
                                 max_neighbors)
    return _to_neighbor_lists(idx, count, max_neighbors)


def _check_shape(lib: ctypes.CDLL) -> None:
    """Raise unless the library prunes by :data:`GROUP_COLS` and
    :data:`BAND_ROWS`."""
    i32 = ctypes.c_int
    lib.neighbor_lists_shape.argtypes = [ctypes.POINTER(i32)] * 2
    lib.neighbor_lists_shape.restype = None
    group, band = i32(), i32()
    lib.neighbor_lists_shape(ctypes.byref(group), ctypes.byref(band))
    if (group.value, band.value) != (GROUP_COLS, BAND_ROWS):
        raise RuntimeError(
            f"neighbor_lists: the library prunes by groups of {group.value} "
            f"and bands of {band.value}, the wrapper expects {GROUP_COLS} "
            f"and {BAND_ROWS}")


def cuda_idx_count(lo: Tensor, hi: Tensor, dyn: Tensor, layer: Tensor,
                   mask: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """The CUDA kernel on the current stream, margins already applied:
    (idx int32[N, k], count int32[N] of all passing columns)."""
    n = lo.shape[0]
    if n < 1 or k < 1:
        raise ValueError(f"neighbor_lists: needs n >= 1 and k >= 1, got "
                         f"n={n}, k={k}")
    device = lo.device
    for name, t, dtype, shape in (
            ("mn", lo, torch.float32, (n, 3)), ("mx", hi, torch.float32, (n, 3)),
            ("dyn", dyn, torch.int32, (n,)), ("layer", layer, torch.int32, (n,)),
            ("mask", mask, torch.int32, (n,))):
        if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"neighbor_lists: {name} must be {dtype}{list(shape)} on "
                f"{device}, got {t.dtype}{list(t.shape)} on {t.device}")
    lo_t = lo.t().contiguous()            # SoA planes [3, n]
    hi_t = hi.t().contiguous()
    dyn, layer, mask = dyn.contiguous(), layer.contiguous(), mask.contiguous()
    bounds = torch.empty((-(-n // GROUP_COLS), 6), dtype=torch.float32,
                         device=device)   # scratch: the group unions
    idx = torch.empty((n, k), dtype=torch.int32, device=device)
    count = torch.empty((n,), dtype=torch.int32, device=device)
    KERNEL.launch(device, lo_t.data_ptr(), hi_t.data_ptr(), dyn.data_ptr(),
                  layer.data_ptr(), mask.data_ptr(), n, k, bounds.data_ptr(),
                  idx.data_ptr(), count.data_ptr())
    return idx, count


def neighbor_lists_aabb(
    mn: Tensor,           # f32[N,3] AABB min (no margin applied yet)
    mx: Tensor,           # f32[N,3] AABB max
    dyn: Tensor,          # int32[N]: -1 not solid, 0 solid static, 1 dynamic
    layer_i: Tensor,      # int32[N]
    mask_i: Tensor,       # int32[N]
    max_neighbors: int = 8,
) -> NeighborLists:
    """All-pairs AABB broadphase over bodies in the given order.

    CUDA tensors always go through the CUDA kernel; CPU tensors through the
    plain version; any other device raises.  Indices in the result refer to
    the order of the inputs.
    """
    lo, hi = with_margin(mn, mx)
    if mn.device.type == "cuda":
        idx, count = cuda_idx_count(lo, hi, dyn, layer_i, mask_i,
                                    max_neighbors)
    elif mn.device.type == "cpu":
        idx, count = plain_idx_count(lo, hi, dyn, layer_i, mask_i,
                                     max_neighbors)
    else:
        raise NotImplementedError(
            f"neighbor_lists_aabb: no kernel for device {mn.device}")
    return _to_neighbor_lists(idx, count, max_neighbors)


_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
KERNEL = cuda_build.HandKernel(
    "broadphase", "bge_neighbor_lists", _SOURCE,
    [_ptr] * 5 + [_i32, _i32] + [_ptr] * 4, on_load=_check_shape,
    wrapper=neighbor_lists_aabb, plain=neighbor_lists_aabb_reference,
    replaces="banggameengine_tpu/physics/broadphase_pallas.py:40")
load_kernel_library = KERNEL.load
