"""Brute-force torch rasterizer — the port's golden model and the oracle
the tile raster kernel (``raster/cuda_raster.py``) is held to.

Evaluates every triangle against every pixel in chunks. O(T * H * W):
for correctness tests at small resolutions and as the semantic definition
the tile kernel must match bit-for-bit (same coefficient math, same tie
rule, same winner selection).

Winner semantics: the covered fragment with minimum depth wins; ties
break to the lowest triangle id. Depth test is LessOrEqual against a
buffer cleared to 1.0 (reference ``GraphicsPipelineCache.cpp:334``, clear
``RenderScene.cpp:213``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .setup import TriSetup, pixel_vectors

INF_DEPTH = 1.0   # depth clear value
NO_TRI = -1
_BIG_ID = 2**31 - 1


class GBuffer(NamedTuple):
    depth: torch.Tensor   # [H,W] f32 in [0,1]; 1.0 where empty (cleared)
    tri_id: torch.Tensor  # [H,W] i32; -1 where empty
    bary: torch.Tensor | None = None    # [H,W,2] winner (b0, b1)
    mat_id: torch.Tensor | None = None  # [H,W] i32 winner material


def _coverage_and_depth(coef, tie, p):
    """coef [K,5,3], tie [K,3], p [H,W,3] -> (cover [K,H,W], depth [K,H,W]).

    The shared semantic core: E>=0 with top-left tie rule, w>0, z in [0,1],
    each plane evaluated as (a*px + b*py) + c in f32.
    """
    c = coef[:, None, None, :, :]              # [K,1,1,5,3]
    px = p[None, ..., 0:1]                     # [1,H,W,1]
    py = p[None, ..., 1:2]
    vals = c[..., 0] * px + c[..., 1] * py + c[..., 2]   # [K,H,W,5]
    e = vals[..., 0:3]
    znum = vals[..., 3]
    wnum = vals[..., 4]
    tie_b = tie[:, None, None, :]
    inside = ((e > 0) | ((e == 0) & tie_b)).all(-1)
    wpos = wnum > 0
    depth = znum / torch.where(wpos, wnum, 1.0)
    # depth bounds tested in RATIONAL space (no divide rounding at the
    # 0/1 boundaries); the tile kernel uses the identical rule
    cover = inside & wpos & (znum >= 0.0) & (znum <= wnum)
    return cover, depth


def rasterize_reference(setup: TriSetup, height: int, width: int,
                        chunk: int = 64, y0: int = 0,
                        full_height: int | None = None,
                        peel_bounds=None) -> GBuffer:
    """Full-image brute force. ``y0``/``full_height`` select a row slice
    of a taller viewport. ``peel_bounds``: optional (prev [H,W], zmax
    [H,W]) — keep only fragments with prev < depth <= zmax (depth
    peeling)."""
    dev = setup.coef.device
    t = setup.coef.shape[0]
    p = pixel_vectors(height, width, y0, full_height, device=dev)
    dmin = torch.full((height, width), INF_DEPTH, dtype=torch.float32,
                      device=dev)
    idmin = torch.full((height, width), _BIG_ID, dtype=torch.int32,
                       device=dev)
    for sl in range(0, t, chunk):
        c = setup.coef[sl:sl + chunk]
        k = c.shape[0]
        cover, depth = _coverage_and_depth(c, setup.tie[sl:sl + chunk], p)
        cover = cover & setup.valid[sl:sl + chunk, None, None]
        if peel_bounds is not None:
            cover = cover & (depth > peel_bounds[0][None]) \
                & (depth <= peel_bounds[1][None])
        depth = torch.where(cover, depth, INF_DEPTH + 1.0)
        ids = sl + torch.arange(k, dtype=torch.int32,
                                device=dev)[:, None, None]
        # lexicographic (depth, id) min within the chunk
        d_c = depth.amin(0)
        id_c = torch.where(depth == d_c[None], ids, _BIG_ID).amin(0)
        any_c = cover.any(0)
        # merge with the carry: LessOrEqual depth test, lowest id on ties
        take = any_c & ((d_c < dmin) | ((d_c == dmin) & (id_c < idmin)))
        dmin = torch.where(take, d_c, dmin)
        idmin = torch.where(take, id_c, idmin)
    tri_id = torch.where(idmin == _BIG_ID, NO_TRI, idmin).to(torch.int32)
    return GBuffer(dmin, tri_id)


def barycentrics_at(coef: torch.Tensor, tri_id: torch.Tensor, height: int,
                    width: int, y0: int = 0, full_height: int | None = None):
    """Normalized perspective-correct barycentrics + 1/w for a G-buffer.

    coef: [T,5,3] full table; tri_id: [H,W] (entries < 0 are empty).
    Returns (bary [H,W,3], w_frag [H,W]): attr = sum(bary_i * u_i).
    """
    safe = tri_id.clamp_min(0).long()
    c = coef[safe]                         # [H,W,5,3]
    p = pixel_vectors(height, width, y0, full_height, device=coef.device)
    vals = c[..., 0] * p[..., 0:1] + c[..., 1] * p[..., 1:2] + c[..., 2]
    e = vals[..., 0:3]
    esum = (e[..., 0] + e[..., 1]) + e[..., 2]
    den = torch.where(esum == 0, 1.0, esum)
    bary = e / den[..., None]
    w_frag = torch.where(vals[..., 4] != 0, vals[..., 4], 1.0) / den
    return bary, w_frag
