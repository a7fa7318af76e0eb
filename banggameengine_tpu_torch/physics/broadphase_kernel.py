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
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from banggameengine_tpu_torch.physics.broadphase import NeighborLists

Tensor = torch.Tensor

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                       "neighbor_lists.cu")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
_CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]
AABB_MARGIN = 0.04   # split across both sides of every pair test
# rows per chunk of the plain version's [rows, N] mask: 2^24 pair entries
# bound its working set to a few hundred MB at N = 10k
_PLAIN_PAIRS_PER_CHUNK = 1 << 24


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


@functools.cache
def load_kernel_library() -> ctypes.CDLL:
    """Build ``csrc/neighbor_lists.cu`` for sm_90a into :data:`BUILD_DIR`
    at first use (ninja rebuilds it when the source is newer than the
    library) and load it.  A failed build raises."""
    from torch.utils.cpp_extension import load

    os.makedirs(BUILD_DIR, exist_ok=True)
    name = "bge_neighbor_lists"
    path = load(name=name, sources=[_SOURCE], extra_cuda_cflags=_CUDA_FLAGS,
                build_directory=BUILD_DIR, is_python_module=False,
                verbose=False)
    lib = ctypes.CDLL(path or os.path.join(BUILD_DIR, name + ".so"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.neighbor_lists_launch.argtypes = [ptr] * 5 + [i32, i32, ptr, ptr, ptr]
    lib.neighbor_lists_launch.restype = i32
    lib.neighbor_lists_error_string.argtypes = [i32]
    lib.neighbor_lists_error_string.restype = ctypes.c_char_p
    return lib


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
    lib = load_kernel_library()
    lo_t = lo.t().contiguous()            # SoA planes [3, n]
    hi_t = hi.t().contiguous()
    dyn, layer, mask = dyn.contiguous(), layer.contiguous(), mask.contiguous()
    idx = torch.empty((n, k), dtype=torch.int32, device=device)
    count = torch.empty((n,), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.neighbor_lists_launch(
            lo_t.data_ptr(), hi_t.data_ptr(), dyn.data_ptr(),
            layer.data_ptr(), mask.data_ptr(), n, k, idx.data_ptr(),
            count.data_ptr(), stream)
    if err != 0:
        msg = lib.neighbor_lists_error_string(err).decode()
        raise RuntimeError(f"neighbor_lists kernel launch failed: {msg}")
    neighbor_lists_aabb.launches += 1
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
    the order of the inputs.  ``neighbor_lists_aabb.launches`` counts kernel
    launches.
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


neighbor_lists_aabb.launches = 0
