"""Vertex transform + clipless triangle setup (torch port of the JAX
package's ``raster/setup.py``).

Triangle setup uses 2D homogeneous (clipless) rasterization: edge
functions come from the adjugate of the 3x3 screen-homogeneous vertex
matrix, so triangles crossing the near plane need no polygon clipping.
For a pixel p = (sx - W/2, sy - H/2, 1):

    E_i(p) = e_i . p          (e_i = +-adjugate column i)
    inside = all E_i >= 0 (with top-left tie rule)
    z_ndc  = (sum E_i z_i) / (sum E_i w_i)
    attr u = (sum E_i u_i) / (sum E_i)       [perspective correct]

Front-facing (Vulkan CCW in framebuffer coords, reference back-cull
config ``GraphicsPipelineCache.cpp:296-297``) corresponds to det(M) < 0;
signs are normalized so interior is E >= 0 for kept triangles.

Every product and sum is written out elementwise in the JAX package's
order (no matmul, no einsum): a float32 matmul may run in TF32 on the
card, and the edge planes need full float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.config import CullMode


class VertexOutputs(NamedTuple):
    """Post-vertex-stage tensors, the analog of primitive.vert outputs."""

    world_pos: torch.Tensor     # [V,3] fragPos
    world_normal: torch.Tensor  # [V,3] fragNormal (normalized)
    uv: torch.Tensor            # [V,2]
    clip: torch.Tensor          # [V,4] gl_Position


class TriSetup(NamedTuple):
    """Per-triangle raster coefficients.

    coef[T,5,3]: rows = (e0, e1, e2, zrow, wrow); for pixel vector p,
    vals = coef @ p gives (E0, E1, E2, z_num, w_num) with
    depth = z_num / w_num and bary_i = E_i / (E0+E1+E2).
    """

    coef: torch.Tensor   # [T,5,3] f32
    tie: torch.Tensor    # [T,3] bool — accept E==0 (top-left rule)
    valid: torch.Tensor  # [T] bool
    bbox: torch.Tensor   # [T,4] i32 (x0,y0,x1,y1) inclusive pixel bounds


def _sum_last(p: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis strictly left to right. A library reduction
    may pair the terms differently on the CPU and the GPU; a fixed order
    keeps the two devices bit-identical."""
    acc = p[..., 0]
    for i in range(1, p.shape[-1]):
        acc = acc + p[..., i]
    return acc


def viewproj(view: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """proj @ view as an explicit f32 sum of products (no matmul)."""
    return _sum_last(proj[:, None, :] * view.t()[None, :, :])


def clip_coords(world: torch.Tensor, vp: torch.Tensor) -> torch.Tensor:
    """[V,4] clip coords of world-space points [V,3] under ``vp``."""
    world_h = torch.cat([world, torch.ones_like(world[:, :1])], dim=-1)
    return _sum_last(vp[None, :, :] * world_h[:, None, :])


def vertex_transform(scene: dict, view: torch.Tensor,
                     proj: torch.Tensor) -> VertexOutputs:
    """All-scene vertex stage (reference ``primitive.vert:49-57``): world =
    node transform; clip = proj @ view @ world; normals through the
    per-node inverse-transpose (hoisted to scene upload). The frame uses
    the world-space cache instead (``graph.frame.cached_vertex_outputs``)."""
    pos, nrm = scene["positions"], scene["normals"]
    node = scene["vert_node"].long()
    tf = scene["transforms"][node]               # [V,4,4]
    nmat = scene["normal_mats"][node]            # [V,3,3]
    h = _sum_last(tf[:, :3, :3] * pos[:, None, :]) + tf[:, :3, 3]
    w = _sum_last(tf[:, 3, :3] * pos) + tf[:, 3, 3]
    world = h / w[:, None]
    wn = _sum_last(nmat * nrm[:, None, :])
    wn = wn / torch.linalg.vector_norm(wn, dim=-1,
                                       keepdim=True).clamp_min(1e-20)
    clip = clip_coords(world, viewproj(view.to(torch.float32),
                                       proj.to(torch.float32)))
    return VertexOutputs(world, wn, scene["uvs"], clip)


def corner_clip(corner_pos: torch.Tensor, vp: torch.Tensor) -> torch.Tensor:
    """[T,3,4] corner clip coords from STATIC world-space corner positions
    (``scene.upload``'s ``corner_attr[..., 0:3]``): a dense multiply-add
    instead of a per-frame ``clip[tri_vidx]`` gather."""
    return (_sum_last(vp[None, None, :, :3] * corner_pos[:, :, None, :])
            + vp[None, None, :, 3])


def triangle_setup(clip: torch.Tensor, tri_vidx: torch.Tensor, n_tris,
                   width: int, height: int,
                   cull_mode: CullMode = CullMode.BACK,
                   first_tri: int = 0) -> TriSetup:
    """Clipless raster coefficients for every triangle; [first_tri,
    n_tris) is the live range (opaque triangles first, translucent after,
    ``RenderScene.cpp:105-159``)."""
    return triangle_setup_corners(clip[tri_vidx.long()], n_tris, width,
                                  height, cull_mode, first_tri)


def _cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.stack([u[:, 1] * v[:, 2] - u[:, 2] * v[:, 1],
                        u[:, 2] * v[:, 0] - u[:, 0] * v[:, 2],
                        u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0]], dim=-1)


def triangle_setup_corners(c: torch.Tensor, n_tris, width: int, height: int,
                           cull_mode: CullMode = CullMode.BACK,
                           first_tri: int = 0) -> TriSetup:
    """``triangle_setup`` from pre-gathered corner clip coords [T,3,4]."""
    x, y, z, w = c[..., 0], c[..., 1], c[..., 2], c[..., 3]

    # screen-homogeneous coords centered on the viewport middle
    a = x * (width * 0.5)                  # [T,3]
    b = y * (height * 0.5)
    r = torch.stack([a, b, w], dim=-1)     # [T,3,3] rows r0,r1,r2

    # adjugate columns = cross products of rows
    r0, r1, r2 = r[:, 0], r[:, 1], r[:, 2]
    a0 = _cross(r1, r2)
    a1 = _cross(r2, r0)
    a2c = _cross(r0, r1)
    det = (r0[:, 0] * a0[:, 0] + r0[:, 1] * a0[:, 1]) + r0[:, 2] * a0[:, 2]

    if cull_mode == CullMode.BACK:
        orient_ok = det < 0.0              # Vulkan-CCW front face
    elif cull_mode == CullMode.FRONT:
        orient_ok = det > 0.0
    else:
        orient_ok = det != 0.0
    # sign-normalize so interior is E >= 0
    s = torch.where(det < 0, -1.0, 1.0)[:, None]
    e0, e1, e2 = s * a0, s * a1, s * a2c   # [T,3] each

    zrow = e0 * z[:, 0:1] + e1 * z[:, 1:2] + e2 * z[:, 2:3]
    wrow = e0 * w[:, 0:1] + e1 * w[:, 1:2] + e2 * w[:, 2:3]
    coef = torch.stack([e0, e1, e2, zrow, wrow], dim=1)  # [T,5,3]

    # top-left tie rule: accept E==0 iff gradient points "down" (interior
    # below: top edge) or horizontal-left (left edge), in y-down coords.
    e = coef[:, 0:3, :]
    tie = (e[..., 1] > 0) | ((e[..., 1] == 0) & (e[..., 0] > 0))  # [T,3]

    # conservative frustum reject (all-out on one plane)
    out = ((x > w).all(1) | (x < -w).all(1) | (y > w).all(1)
           | (y < -w).all(1) | (z > w).all(1) | (z < 0).all(1))

    # screen bbox (w>0 vertices only; any w<=0 -> conservative full screen)
    eps = 1e-6
    safe_w = torch.where(w > eps, w, 1.0)
    sx = width * 0.5 + a / safe_w
    sy = height * 0.5 + b / safe_w
    any_behind = (w <= eps).any(1)
    x0 = torch.where(any_behind, 0.0, torch.floor(sx.amin(1)))
    y0 = torch.where(any_behind, 0.0, torch.floor(sy.amin(1)))
    x1 = torch.where(any_behind, float(width - 1), torch.ceil(sx.amax(1)))
    y1 = torch.where(any_behind, float(height - 1), torch.ceil(sy.amax(1)))
    x0 = x0.clamp(0, width - 1).to(torch.int32)
    y0 = y0.clamp(0, height - 1).to(torch.int32)
    x1 = x1.clamp(0, width - 1).to(torch.int32)
    y1 = y1.clamp(0, height - 1).to(torch.int32)
    bbox = torch.stack([x0, y0, x1, y1], dim=-1)

    tri_ids = torch.arange(c.shape[0], dtype=torch.int32, device=c.device)
    in_range = (tri_ids < n_tris) & (tri_ids >= first_tri)
    valid = orient_ok & ~out & in_range & (x1 >= x0) & (y1 >= y0)
    return TriSetup(coef.to(torch.float32), tie, valid, bbox)


def pixel_vectors(height: int, width: int, y0: int = 0,
                  full_height: int | None = None,
                  device=None) -> torch.Tensor:
    """[H,W,3] pixel vectors p = (sx+0.5-W/2, sy+0.5-H/2, 1).

    ``y0``/``full_height`` render a row slice [y0, y0+height) of a taller
    virtual viewport.
    """
    fh = height if full_height is None else full_height
    ys = (torch.arange(height, dtype=torch.float32, device=device)
          + (y0 + 0.5 - fh * 0.5))
    xs = torch.arange(width, dtype=torch.float32, device=device) \
        + (0.5 - width * 0.5)
    px = xs[None, :].expand(height, width)
    py = ys[:, None].expand(height, width)
    return torch.stack([px, py, torch.ones_like(px)], dim=-1)


def restrict_rows(setup: TriSetup, y0: int, slice_h: int,
                  full_height: int) -> TriSetup:
    """Restrict a full-viewport TriSetup to rows [y0, y0+slice_h): rebases
    bboxes to slice-local coordinates and invalidates triangles fully
    outside."""
    bbox = setup.bbox
    ny0 = (bbox[:, 1] - y0).clamp(0, slice_h - 1)
    ny1 = (bbox[:, 3] - y0).clamp(0, slice_h - 1)
    inside = (bbox[:, 3] >= y0) & (bbox[:, 1] < y0 + slice_h)
    new_bbox = torch.stack([bbox[:, 0], ny0, bbox[:, 2], ny1], dim=-1)
    return TriSetup(setup.coef, setup.tie, setup.valid & inside,
                    new_bbox.to(torch.int32))
