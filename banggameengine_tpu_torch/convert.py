"""Carry state between the JAX package and the port through numpy.

The JAX pytrees arrive as dicts of numpy arrays, one entry per dataclass
field (``{f.name: np.asarray(getattr(s, f.name)) for f in fields(s)}``),
so this module needs neither JAX nor the JAX package.  Every conversion is
bit-exact: the JAX package's ``uint32`` bit fields become ``int32`` by a bit
view, never a value cast, and come back the same way.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from banggameengine_tpu_torch.state import (
    InputFrame,
    StaticScene,
    WorldState,
)

# fields stored as uint32 by the JAX package and as int32 here
_UINT32_FIELDS = frozenset(
    {"comp_mask", "layer", "mask", "trig_layer", "trig_mask"})


def _from_numpy(cls, arrays: dict, device):
    out = {}
    for f in dataclasses.fields(cls):
        a = np.array(arrays[f.name], copy=True)
        if f.name in _UINT32_FIELDS:
            a = a.astype(np.uint32, copy=False).view(np.int32)
        out[f.name] = torch.from_numpy(a).to(device)
    return cls(**out)


def _to_numpy(obj) -> dict:
    out = {}
    for f in dataclasses.fields(obj):
        a = getattr(obj, f.name).detach().cpu().numpy()
        if f.name in _UINT32_FIELDS:
            a = a.view(np.uint32)
        out[f.name] = a
    return out


def world_state_from_numpy(arrays: dict, device="cpu") -> WorldState:
    return _from_numpy(WorldState, arrays, device)


def static_scene_from_numpy(arrays: dict, device="cpu") -> StaticScene:
    return _from_numpy(StaticScene, arrays, device)


def input_frame_from_numpy(arrays: dict, device="cpu") -> InputFrame:
    return _from_numpy(InputFrame, arrays, device)


def world_state_to_numpy(state: WorldState) -> dict:
    return _to_numpy(state)


def static_scene_to_numpy(static: StaticScene) -> dict:
    return _to_numpy(static)


def input_frame_to_numpy(inp: InputFrame) -> dict:
    return _to_numpy(inp)
