"""Exact rasterization over triangle bounding boxes.

The semantics of the brute-force oracle (``reference_raster.py``): a pixel
is covered where all three edge values are > 0 (== 0 on a top-left edge),
w > 0 and 0 <= z <= w, each plane evaluated as ``(a*px + b*py) + c`` in
float32; the nearest fragment wins, the lowest triangle id on equal
depths; ``peel_bounds`` keep prev < depth <= zmax. Only the pixels inside
each valid triangle's bounding box (``TriSetup.bbox``, inclusive) are
evaluated, in chunks of at most ``chunk`` (triangle, pixel) candidates,
and the winner of each pixel is the minimum of one int64 key per
candidate: the depth's bits above the triangle id.
"""

from __future__ import annotations

import torch

from .reference_raster import GBuffer, INF_DEPTH, NO_TRI

_ID_BITS = 31
_EMPTY = torch.iinfo(torch.int64).max


def rasterize_binned(setup, height: int, width: int, peel_bounds=None,
                     chunk: int = 1 << 24, counts: dict | None = None
                     ) -> GBuffer:
    """[H,W] depth and triangle ids of the nearest covered fragment.
    ``counts``, if given, gains ``fragments`` (covered (triangle, pixel)
    pairs before the peel bounds, a device tensor) and ``triangles`` (the
    valid triangles)."""
    dev = setup.coef.device
    ids = torch.nonzero(setup.valid).squeeze(1)
    bb = setup.bbox[ids].long()
    bw = bb[:, 2] - bb[:, 0] + 1
    area = bw * (bb[:, 3] - bb[:, 1] + 1)
    ends = torch.cumsum(area, 0)
    starts = ends - area
    best = torch.full((height * width,), _EMPTY, dtype=torch.int64,
                      device=dev)
    if counts is not None:
        # a pass with no valid triangle (a cube face that sees nothing)
        # counts no fragment
        counts.setdefault("fragments", 0)
    # chunk boundaries on the host: triangles [a, b) with at most ``chunk``
    # candidates, or one triangle alone where its box is larger
    ends_h = ends.tolist()
    a = 0
    while a < len(ends_h):
        base = ends_h[a - 1] if a else 0
        b = a + 1
        while b < len(ends_h) and ends_h[b] - base <= chunk:
            b += 1
        sel = torch.arange(a, b, device=dev)
        n = area[a:b]
        tri = torch.repeat_interleave(sel, n)
        k = torch.arange(base, ends_h[b - 1], device=dev) - starts[tri]
        x = bb[tri, 0] + k % bw[tri]
        y = bb[tri, 1] + k // bw[tri]
        tid = ids[tri]
        c = setup.coef[tid]                                  # [N,5,3]
        px = (x.to(torch.float32) + (0.5 - width * 0.5))[:, None]
        py = (y.to(torch.float32) + (0.5 - height * 0.5))[:, None]
        vals = c[..., 0] * px + c[..., 1] * py + c[..., 2]   # [N,5]
        e = vals[:, 0:3]
        znum, wnum = vals[:, 3], vals[:, 4]
        tie = setup.tie[tid]
        inside = ((e > 0) | ((e == 0) & tie)).all(-1)
        wpos = wnum > 0
        depth = znum / torch.where(wpos, wnum, 1.0)
        cover = inside & wpos & (znum >= 0.0) & (znum <= wnum)
        pix = y * width + x
        if counts is not None:
            counts["fragments"] = counts["fragments"] + cover.sum()
        if peel_bounds is not None:
            cover = cover & (depth > peel_bounds[0].reshape(-1)[pix]) \
                & (depth <= peel_bounds[1].reshape(-1)[pix])
        # + 0.0 turns -0.0 into +0.0: the bits of a depth in [0, 1] then
        # order as the depths do
        dbits = (depth[cover] + 0.0).view(torch.int32).to(torch.int64)
        key = (dbits << _ID_BITS) | tid[cover]
        best.scatter_reduce_(0, pix[cover], key, reduce="amin")
        a = b
    if counts is not None:
        counts["triangles"] = int(ids.shape[0])
    empty = best == _EMPTY
    tri_id = torch.where(empty, NO_TRI, best & ((1 << _ID_BITS) - 1))
    depth = torch.where(empty, INF_DEPTH,
                        (best >> _ID_BITS).to(torch.int32)
                        .view(torch.float32))
    return GBuffer(depth.reshape(height, width),
                   tri_id.to(torch.int32).reshape(height, width))
