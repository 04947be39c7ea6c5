"""Editor ground grid — full-screen procedural pass.

Port of ``Assets/Shaders/grid.{vert,frag}``: per-pixel near/far unprojected
rays intersect the y=0 plane; anti-aliased two-scale grid lines with axis
coloring; computes its own depth and blends over the scene. The reference
constructs the Grid but never draws it (SURVEY §2.3 quirk); here it is
drawable behind ``RenderConfig.grid`` (the intent of main.cpp:27's
showGrid option). Tensor code on the frame's device; ``fwidth`` is built
from the quad derivatives of ``shading/sampling.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from .sampling import quad_dfdx, quad_dfdy


def grid_unproject_matrix(view: np.ndarray, proj: np.ndarray) -> np.ndarray:
    """Host-side inverse(proj @ view) (grid.vert:47-52)."""
    return np.linalg.inv(np.asarray(proj, np.float64)
                         @ np.asarray(view, np.float64)).astype(np.float32)


def _grid_color(pos_x: torch.Tensor, pos_z: torch.Tensor, scale: float):
    """grid() from grid.frag:31-52: anti-aliased lines + axis coloring."""
    cx = pos_x * scale
    cz = pos_z * scale
    dx = quad_dfdx(cx).abs() + quad_dfdy(cx).abs()      # fwidth
    dz = quad_dfdx(cz).abs() + quad_dfdy(cz).abs()
    gx = (torch.remainder(cx - 0.5, 1.0) - 0.5).abs() / dx.clamp_min(1e-9)
    gz = (torch.remainder(cz - 0.5, 1.0) - 0.5).abs() / dz.clamp_min(1e-9)
    line = torch.minimum(gx, gz)
    min_x = dx.clamp_max(1.0)
    min_z = dz.clamp_max(1.0)
    grey = torch.full_like(cx, 0.2)
    a = 1.0 - line.clamp_max(1.0)
    b = torch.where((pos_x > -0.1 * min_x) & (pos_x < 0.1 * min_x), 1.0,
                    grey)                                   # z axis
    r = torch.where((pos_z > -0.1 * min_z) & (pos_z < 0.1 * min_z), 1.0,
                    grey)                                   # x axis
    return torch.stack([r, grey, b, a], dim=-1)


def render_grid(inv_vp: torch.Tensor, view: torch.Tensor, proj: torch.Tensor,
                scene_depth: torch.Tensor, rgb: torch.Tensor,
                near: float = 0.1, far: float = 100.0,
                y0: int = 0, full_height: int | None = None) -> torch.Tensor:
    """Blend the grid over rgb where its depth passes LessOrEqual against
    the scene depth. Shapes: scene_depth/rgb [H,W(,3)]. ``y0``/
    ``full_height`` shade a row slice of a taller viewport."""
    h, w = scene_depth.shape
    fh = h if full_height is None else full_height
    dev = scene_depth.device
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + float(y0)
          + 0.5) / fh * 2.0 - 1.0
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w \
        * 2.0 - 1.0
    ndc_x = xs[None, :].expand(h, w)
    ndc_y = ys[:, None].expand(h, w)
    inv_vp = inv_vp.to(torch.float32)

    def unproject(z: float):
        p = torch.stack([ndc_x, ndc_y, torch.full_like(ndc_x, z),
                         torch.ones_like(ndc_x)], -1)
        q = (inv_vp[None, None] * p[:, :, None, :]).sum(-1)
        return q[..., :3] / torch.where(q[..., 3:4] == 0, 1.0, q[..., 3:4])

    near_pt = unproject(0.0)
    far_pt = unproject(1.0)

    dy = far_pt[..., 1] - near_pt[..., 1]
    t = -near_pt[..., 1] / torch.where(far_pt[..., 1] == near_pt[..., 1],
                                       1.0, dy)
    pos = near_pt + t[..., None] * (far_pt - near_pt)

    c = (_grid_color(pos[..., 0], pos[..., 2], 10.0)
         + _grid_color(pos[..., 0], pos[..., 2], 1.0)) * (t > 0)[..., None]

    # computeDepth (grid.frag:55-58)
    vp = proj.to(torch.float32) @ view.to(torch.float32)
    ph = torch.cat([pos, torch.ones_like(pos[..., :1])], -1)
    clip = (vp[None, None] * ph[:, :, None, :]).sum(-1)
    depth = clip[..., 2] / torch.where(clip[..., 3] == 0, 1.0, clip[..., 3])

    # computeLinearDepth with the hardcoded near=0.1 far=100 (grid.frag:60-67)
    csd = depth * 2.0 - 1.0
    linear_depth = (2.0 * 0.1 * 100.0) / (100.0 + 0.1 - csd * (100.0 - 0.1)) \
        / 100.0
    spotlight = (1.0 - linear_depth).clamp_min(0.0)

    alpha = (c[..., 3] * spotlight).clamp(0.0, 1.0)
    visible = ((depth <= scene_depth) & (depth >= 0.0) & (depth <= 1.0)
               & (t > 0))
    a = torch.where(visible, alpha, 0.0)[..., None]
    return rgb * (1 - a) + c[..., :3] * a
