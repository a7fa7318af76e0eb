"""RenderSystem: the explicit submit-style render path.

Counterpart of ``banggameengine_tpu/ecs/render_system.py`` (the
reference's ``RenderSystem``: iterate the MeshRenderers, one
``Renderer::SubmitMeshLit`` each; dead code on its main path, where the
renderer walks the scene itself).  :func:`gather_submissions` lists the
per-(entity, submesh) draws the submit path would make, from the baked
render soup, on the host; :func:`render_submissions` renders exactly
that subset through ``render_frame``, every other triangle masked out.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from banggameengine_tpu_torch.render.pipeline import render_frame


@dataclasses.dataclass
class Submission:
    """One SubmitMeshLit-equivalent draw (entity, triangle range, material)."""

    entity: int
    tri_start: int
    tri_count: int
    material: int


def gather_submissions(render_scene) -> list[Submission]:
    """The draw list: each run of consecutive valid triangles of one
    entity and one material (one read of the soup's tables)."""
    tri_entity = render_scene.v_entity[::3].cpu().numpy()
    tri_material = render_scene.tri_material.cpu().numpy()
    tri_valid = render_scene.tri_valid.cpu().numpy()

    subs: list[Submission] = []
    start = 0
    n = len(tri_material)
    for i in range(1, n + 1):
        boundary = (
            i == n
            or tri_entity[i] != tri_entity[start]
            or tri_material[i] != tri_material[start]
            or tri_valid[i] != tri_valid[start]
        )
        if boundary:
            if tri_valid[start]:
                subs.append(Submission(entity=int(tri_entity[start]),
                                       tri_start=start, tri_count=i - start,
                                       material=int(tri_material[start])))
            start = i
    return subs


def render_submissions(render_scene, submissions, world_mats, view, proj,
                       camera_pos, width: int, height: int, **kwargs):
    """Render only the given submissions (every other triangle masked
    out); ``kwargs`` go to ``render_frame``."""
    mask = np.zeros(render_scene.tri_material.shape[0], bool)
    for s in submissions:
        mask[s.tri_start: s.tri_start + s.tri_count] = True
    masked = dataclasses.replace(
        render_scene, tri_valid=render_scene.tri_valid & torch.as_tensor(
            mask, device=render_scene.tri_valid.device))
    return render_frame(masked, world_mats, view, proj, camera_pos,
                        width=width, height=height, **kwargs)
