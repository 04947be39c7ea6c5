"""Skybox pass: cubemap sample at far depth for uncovered pixels (torch
port of the JAX package's ``shading/skybox.py``).

Reference: ``Assets/Shaders/skybox.{vert,frag}`` — the cube draws last with
``pos.xyww`` (depth 1.0) and LessOrEqual depth, i.e. it fills exactly the
pixels nothing else wrote. Deferred equivalent: composite the cubemap where
tri_id < 0. The view ray uses the rotation-only view matrix
(``skybox.vert:35``: ``mat4(mat3(view))``).
"""

from __future__ import annotations

import numpy as np
import torch

from .sampling import sample_cubemap


def skybox_ray_matrix(view: np.ndarray, proj: np.ndarray) -> np.ndarray:
    """Host-side: inverse(proj @ rotation-only-view), for unprojecting NDC
    points to world-space view rays."""
    v = np.asarray(view, np.float64).copy()
    v[:3, 3] = 0.0
    return np.linalg.inv(np.asarray(proj, np.float64) @ v).astype(np.float32)


def _view_rays(inv_vp_rot: torch.Tensor, xs: torch.Tensor,
               ys: torch.Tensor) -> torch.Tensor:
    """Unit world-space view rays [len(ys), len(xs), 3] through the NDC
    points (x, y, 1, 1)."""
    h, w = ys.shape[0], xs.shape[0]
    ndc_x = xs[None, :].expand(h, w)
    ndc_y = ys[:, None].expand(h, w)
    one = torch.ones_like(ndc_x)
    ndc = torch.stack([ndc_x, ndc_y, one, one], dim=-1)
    q = inv_vp_rot * ndc[:, :, None, :]                    # [H,W,4,4]
    p = ((q[..., 0] + q[..., 1]) + q[..., 2]) + q[..., 3]
    d = p[..., :3] / torch.where(p[..., 3:4] == 0, 1.0, p[..., 3:4])
    n = torch.sqrt((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
                   + d[..., 2] * d[..., 2])
    return d / n.clamp_min(1e-20)[..., None]


def render_skybox(cube, inv_vp_rot: torch.Tensor, height: int, width: int,
                  y0: int = 0, full_height: int | None = None) -> torch.Tensor:
    """Returns rgba f32 [H,W,4] (storage-space values, sampled raw as the
    reference does). ``y0``/``full_height`` render a row slice of a taller
    viewport."""
    fh = height if full_height is None else full_height
    dev = inv_vp_rot.device
    ys = (torch.arange(height, dtype=torch.float32, device=dev) + float(y0)
          + 0.5) / fh * 2.0 - 1.0
    xs = (torch.arange(width, dtype=torch.float32, device=dev)
          + 0.5) / width * 2.0 - 1.0
    return sample_cubemap(cube, _view_rays(inv_vp_rot, xs, ys))


def render_skybox_halfres(cube, inv_vp_rot: torch.Tensor, height: int,
                          width: int, y0: int = 0,
                          full_height: int | None = None) -> torch.Tensor:
    """``render_skybox`` sampled on the EVEN-pixel half grid + a bilinear
    upsample back to full res: the sky is massively magnified at screen
    res (one cube texel spans many pixels), so a quarter of the gather
    indices costs nothing visually."""
    h2 = (height + 1) // 2
    w2 = (width + 1) // 2
    fh = height if full_height is None else full_height
    dev = inv_vp_rot.device
    # half-grid rays at the EVEN pixel centers of the full grid
    ys = (torch.arange(h2, dtype=torch.float32, device=dev) * 2.0
          + float(y0) + 0.5) / fh * 2.0 - 1.0
    xs = (torch.arange(w2, dtype=torch.float32, device=dev) * 2.0
          + 0.5) / width * 2.0 - 1.0
    half = sample_cubemap(cube, _view_rays(inv_vp_rot, xs, ys))  # [h2,w2,4]

    # bilinear 2x upsample: odd rows/cols mix the two nearest half
    # samples (weight .5), clamped at the far edge
    def up_axis(a, axis, n_full):
        n = a.shape[axis]
        nxt = torch.cat([a.narrow(axis, 1, n - 1), a.narrow(axis, n - 1, 1)],
                        dim=axis)
        out = torch.stack([a, 0.5 * (a + nxt)], dim=axis + 1)
        shp = list(a.shape)
        shp[axis] = n * 2
        return out.reshape(shp).narrow(axis, 0, n_full)

    return up_axis(up_axis(half, 1, width), 0, height)
