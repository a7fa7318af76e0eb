"""Checkpoint and resume of the simulation state.

Counterpart of ``banggameengine_tpu/utils/checkpoint.py`` (the reference
has no save game; the F5 scene reset comes closest): a WorldState, one
world or a batch of worlds, round-trips through a compressed ``.npz``
with one array per field under the field's name, and a JSON header
(``__header__``: format version, capacity, whether batched, the caller's
metadata).  The format is the JAX package's, ``comp_mask`` included as
uint32 (the bits of the port's int32), so a file written by either
package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from banggameengine_tpu_torch import convert
from banggameengine_tpu_torch.state import WorldState

FORMAT_VERSION = 1


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, state: WorldState,
                    metadata: dict | None = None) -> None:
    """Write a WorldState to ``path`` (``.npz`` appended if missing),
    atomically: a temporary file, then a rename."""
    path = _npz(path)
    fields = convert.world_state_to_numpy(state)       # one read a field
    header = json.dumps({
        "format_version": FORMAT_VERSION,
        "capacity": int(state.capacity),
        "batched": fields["alive"].ndim > 1,
        "metadata": metadata or {},
    })
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(
            f, __header__=np.frombuffer(header.encode(), np.uint8), **fields)
    os.replace(tmp, path)


def load_checkpoint(path: str, device: torch.device | str = "cuda"
                    ) -> tuple[WorldState, dict]:
    """Read a WorldState back onto ``device``.  Returns (state, metadata);
    raises ValueError for another format version."""
    path = _npz(path)
    with np.load(path) as data:
        header = json.loads(bytes(data["__header__"]).decode())
        if header.get("format_version") != FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format {header.get('format_version')} != "
                f"{FORMAT_VERSION}"
            )
        arrays = {f.name: data[f.name]
                  for f in dataclasses.fields(WorldState)}
    return (convert.world_state_from_numpy(arrays, device),
            header.get("metadata", {}))
