"""Broadphase result container.

Counterpart of ``NeighborLists`` in ``banggameengine_tpu/physics/broadphase.py``.
The grid and dense broadphase routes of the JAX package are not ported; the
all-pairs route lives in :mod:`broadphase_kernel`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class NeighborLists(NamedTuple):
    idx: torch.Tensor            # int32[N, K] neighbor body ids, -1 padded
    valid: torch.Tensor          # bool[N, K]
    cell_overflow: torch.Tensor  # int32[] bodies dropped from full cells
    nbr_overflow: torch.Tensor   # int32[] candidate pairs dropped from full rows
