"""A dense-tile stress scene for the split tile walk of K1 and K2.

Hundreds of small triangles crowd one 8x32 tile of a 128x48 viewport, so
that the kernels cut that tile's pair span into many work items and merge
them; a few random triangles cover the rest. The pair table also carries
the ties the merge must keep exact:

- duplicated triangles (same vertices, higher ids): equal depths, which
  go to the lowest triangle id;
- pairs whose z plane evaluates to -0.0 at every pixel of their tile
  (zero coefficients, signed against the tile's pixel coordinates), so a
  covered fragment has depth -0.0, equal to +0.0 in every compare;
- pairs whose z plane equals their w plane: depth exactly 1.0, the clear
  depth, which never enters a layer;

and ``stress_bounds`` gives peel bounds equal to fragment depths (the
nearest and second layer of the whole walk), so ``prev < d`` excludes and
``d <= zmax`` includes an exact hit.

Used by ``chip_smoke.py`` (phase split-stress), ``tests/test_torch_gpu.py``
and ``tests/test_torch_split_merge.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import CullMode
from ..raster import cuda_raster as cr
from ..raster.setup import restrict_rows, triangle_setup

WIDTH, HEIGHT = 128, 48      # tile edges fall on px = 0 and py = 0


def _clip(rng, n_dense: int, n_back: int) -> np.ndarray:
    """[T, 3, 4] clip-space corners (w = 1): n_dense small triangles in one
    box of NDC (about one tile), an eighth of them duplicates of earlier
    ones, then n_back random triangles anywhere."""
    lo = np.array([0.08, 0.06], np.float32)
    hi = np.array([0.42, 0.30], np.float32)
    n_dup = n_dense // 8
    xy = lo + (hi - lo) * rng.uniform(0, 1, (n_dense - n_dup, 3, 2))
    z = rng.uniform(0.2, 0.8, (n_dense - n_dup, 3))
    pick = rng.integers(0, n_dense - n_dup, n_dup)
    xy = np.concatenate([xy, xy[pick]])
    z = np.concatenate([z, z[pick]])
    scale = rng.uniform(0.05, 0.8, (n_back, 1, 1))
    centre = rng.uniform(-1.0, 1.0, (n_back, 1, 2))
    xy = np.concatenate([xy, centre + scale * rng.uniform(-1, 1,
                                                          (n_back, 3, 2))])
    z = np.concatenate([z, rng.uniform(0.05, 0.95, (n_back, 3))])
    ones = np.ones(z.shape + (1,))
    return np.concatenate([xy, z[..., None], ones], -1).astype(np.float32)


def stress_pairs(seed: int = 0, n_attrs: int = 0, n_dense: int = 600,
                 n_back: int = 24, y0: int = 0, slice_h: int | None = None,
                 device="cpu") -> cr.PreparedPairs:
    """Binned and packed pairs of the stress scene (``WIDTH`` x ``HEIGHT``,
    or rows [y0, y0 + slice_h) of it; y0 a multiple of 8), with
    ``n_attrs`` random attribute planes and material ids tri % 5. Pairs of
    triangles with id % 7 == 3 get the -0.0 z plane, id % 11 == 5 the
    depth-1.0 one."""
    rng = np.random.default_rng(seed)
    corners = _clip(rng, n_dense, n_back)
    t = corners.shape[0]
    vidx = torch.arange(3 * t, dtype=torch.int32).reshape(t, 3)
    s = triangle_setup(torch.from_numpy(corners.reshape(-1, 4)), vidx, t,
                       WIDTH, HEIGHT, CullMode.NONE)
    h = HEIGHT
    if slice_h is not None:
        s = restrict_rows(s, y0, slice_h, HEIGHT)
        h = slice_h
    ap = None
    if n_attrs:
        ap = cr.attribute_planes(s, torch.from_numpy(
            rng.uniform(-5, 5, (t, 3, n_attrs)).astype(np.float32)))
    prep = cr.prepare_pairs(s, h, WIDTH, max_pairs=4 * t + 4096,
                            attr_planes=ap,
                            tri_mat=torch.arange(t, dtype=torch.int32) % 5)
    b = prep.bins
    pd = prep.pair_data.clone()
    ntx = -(-WIDTH // cr.TILE_W)
    tile = torch.repeat_interleave(torch.arange(b.counts.shape[0]),
                                   b.counts.long())
    tri = pd[: tile.shape[0], cr.TRI_COL].long()
    # -0.0 z plane: 0 * px is -0.0 when the zero's sign is against px's
    px0 = (tile % ntx * cr.TILE_W).float() + (0.5 - WIDTH * 0.5)
    py0 = (tile // ntx * cr.TILE_H + y0).float() + (0.5 - HEIGHT * 0.5)
    neg = tri % 7 == 3
    zero = torch.zeros_like(px0)
    rows = pd[: tile.shape[0]]
    rows[neg, 9] = torch.where(px0 > 0, -zero, zero)[neg]
    rows[neg, 10] = torch.where(py0 > 0, -zero, zero)[neg]
    rows[neg, 11] = -zero[neg]
    one = tri % 11 == 5
    rows[one, 9:12] = rows[one, 12:15]
    bins = type(b)(*(x.to(device) if torch.is_tensor(x) else x for x in b))
    return cr.PreparedPairs(bins, pd.to(device), prep.has_mat, prep.n_attrs)


def stress_bounds(prep: cr.PreparedPairs, y0: int = 0) -> dict:
    """Peel bounds in tile layout, equal to fragment depths: ``"peel"`` =
    (layer-1 depth, layer-2 depth) of the whole dual walk, so a single peel
    finds layer 2 (its depth equals zmax) and never layer 1 (equal to
    prev); ``"dual"`` = (-1, layer-2 depth)."""
    b = prep.bins
    ntx = -(-WIDTH // cr.TILE_W)
    free = torch.stack([torch.full((b.counts.shape[0], 256), -1.0),
                        torch.full((b.counts.shape[0], 256), 2.0)], 1)
    pd = prep.pair_data.cpu()
    out = cr._raster_tiles_plain(pd, b.starts.cpu(), b.counts.cpu(), ntx,
                                 WIDTH, HEIGHT, y0, prep.n_attrs, free,
                                 dual=True)
    pp = cr._n_planes(prep.n_attrs)
    d1, d2 = out[:, 0], out[:, pp]
    dev = prep.pair_data.device
    return {"peel": torch.stack([d1, d2], 1).contiguous().to(dev),
            "dual": torch.stack([torch.full_like(d1, -1.0), d2],
                                1).contiguous().to(dev)}


def densest_tile(prep: cr.PreparedPairs) -> tuple[int, int]:
    """(tile index, pair count) of the tile with the most pairs."""
    c = prep.bins.counts
    i = int(c.argmax())
    return i, int(c[i])
