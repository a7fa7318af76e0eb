"""Debug-line rasterization over a rendered frame.

Counterpart of ``banggameengine_tpu/render/lines.py`` (the reference's
``Renderer::DrawDebugLines`` line pass with a LESS depth test): 3D
segments are projected, clipped to the near plane, sampled at 128 fixed
parametric steps, depth-tested against the scene depth and composited
into the frame.  Line counts are debug-scale (hundreds), so the pass is
plain tensor math, not a hot path.

Where several passing samples land on one pixel, the JAX package's
scatter applies them in sample order and the last one wins.  A CUDA
scatter promises no order, so the winner is chosen explicitly: each
pixel keeps the passing sample of the highest flat index ``l * 128 + s``
(an ``amax`` scatter of the indices, then a gather of the colours), which
is the same pixel on every run and on every device.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

SAMPLES_PER_LINE = 128


def sample_params(device: torch.device | str) -> Tensor:
    """The samples' parameters f32[128] in [0, 1]: ``jnp.linspace(0, 1,
    128)``'s values, ``i`` times the f32 reciprocal of 127 (XLA's form of
    its division), then 1.  ``torch.linspace`` and an f32 division each
    differ from them by up to 6e-8, which moves ``floor`` across pixel
    borders."""
    i = torch.arange(SAMPLES_PER_LINE - 1, dtype=torch.float32,
                     device=device)
    recip = torch.full((), 1.0 / (SAMPLES_PER_LINE - 1), dtype=torch.float32,
                       device=device)
    return torch.cat([i * recip, torch.ones(1, device=device)])


def draw_lines(
    frame: Tensor,        # u8[H, W, 4]
    depth: Tensor,        # f32[H, W] scene NDC depth
    points: Tensor,       # f32[L, 2, 3] world-space segment endpoints
    colors: Tensor,       # f32[L, 4]
    valid: Tensor,        # bool[L]
    view: Tensor, proj: Tensor,
    depth_bias: float = 1e-4,
) -> Tensor:
    """Composite coloured 3D lines into ``frame``; returns a new u8[H, W, 4]
    on the frame's device, with no host synchronisation."""
    h, w = frame.shape[:2]
    n_lines = points.shape[0]
    vp = torch.matmul(proj, view)
    p4 = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    clip = torch.einsum("ij,lkj->lki", vp, p4)                  # [L, 2, 4]

    # near-plane clip per segment (z_clip >= 0)
    za, zb = clip[:, 0, 2], clip[:, 1, 2]
    dz = za - zb
    t_cross = za / torch.where(dz.abs() > 1e-12, dz, 1e-12)
    cross = clip[:, 0] + (clip[:, 1] - clip[:, 0]) * t_cross[:, None]
    pa = torch.where((za < 0)[:, None], cross, clip[:, 0])
    pb = torch.where((zb < 0)[:, None], cross, clip[:, 1])
    ok = valid & ~((za < 0) & (zb < 0))

    ts = sample_params(frame.device)
    pts = pa[:, None, :] + (pb - pa)[:, None, :] * ts[None, :, None]
    wclip = pts[..., 3].clamp_min(1e-6)
    ndc = pts[..., :3] / wclip[..., None]
    sx = (ndc[..., 0] * 0.5 + 0.5) * w
    sy = (1.0 - (ndc[..., 1] * 0.5 + 0.5)) * h
    sz = ndc[..., 2]

    # bounds tested on the floored floats: a cast of an out-of-range float
    # to int32 is undefined in PyTorch (saturating in XLA)
    xf, yf = torch.floor(sx), torch.floor(sy)
    on = (ok[:, None] & (xf >= 0) & (xf < w) & (yf >= 0) & (yf < h)
          & (sz >= 0.0) & (sz <= 1.0))
    xi = xf.clamp(0, w - 1).to(torch.int64)
    yi = yf.clamp(0, h - 1).to(torch.int64)

    # depth test LESS against the scene (small bias: coplanar lines win)
    passes = on & (sz <= depth[yi, xi] + depth_bias)

    # the last passing sample of each pixel wins, as in the JAX scatter
    order = torch.arange(n_lines * SAMPLES_PER_LINE, device=frame.device)
    key = torch.where(passes.reshape(-1), order, -1)
    winner = torch.full((h * w,), -1, dtype=torch.int64, device=frame.device)
    winner.scatter_reduce_(0, (yi * w + xi).reshape(-1), key, "amax")
    rgba = (colors.clamp(0, 1) * 255).to(torch.uint8)           # [L, 4]
    src = rgba[winner.clamp_min(0) // SAMPLES_PER_LINE]
    flat = torch.where((winner >= 0)[:, None], src, frame.reshape(h * w, 4))
    return flat.reshape(h, w, 4)
