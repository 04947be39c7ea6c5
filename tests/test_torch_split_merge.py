"""The merge rule of the split tile walk, held on the CPU. K1 and K2 cut a
dense tile's pair span into work items and merge the items' nearest
layers (``csrc/raster_tile.cu``); here each tile's span is cut into chunks
by editing starts/counts, the plain versions walk each chunk, and
``cuda_raster.merge_chunk_planes`` / ``merge_chunk_merged`` merge the
results. Tolerance, stated: the merge equals the whole walk bit for bit
(``torch.equal``: depths with their sign, ids, attributes), in every mode
(single, peel, dual; n_attrs 0/4/8; dense and sparse grids) and for K2's
fold, at chunk sizes 1, 2, 3 and 64.

Inputs: random triangles, and the dense-tile stress scene of
``tools/split_stress.py`` (one tile of a few hundred pairs, duplicated
triangles at equal depth, fragments at depth -0.0 and exactly 1.0, peel
bounds equal to fragment depths)."""

import numpy as np
import pytest
import torch

from renderengine_tpu_torch.core.config import CullMode
from renderengine_tpu_torch.raster import cuda_raster as cr
from renderengine_tpu_torch.raster.setup import triangle_setup
from renderengine_tpu_torch.tools import split_stress as ss

torch.set_num_threads(2)

CHUNKS = (1, 2, 3, 64)
N_DENSE = 160                 # the stress tile's pairs, kept small for time


def _random_prep(seed, n_attrs, w=97, h=61, n=60):
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.02, 1.0, (n, 1, 1)).astype(np.float32)
    center = rng.uniform(-1.1, 1.1, (n, 1, 2)).astype(np.float32)
    tri = center + scale * rng.uniform(-1, 1, (n, 3, 2)).astype(np.float32)
    z = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    clip = np.concatenate([tri, z[..., None], np.ones((n, 3, 1), np.float32)],
                          -1).reshape(-1, 4)
    vidx = torch.arange(3 * n, dtype=torch.int32).reshape(n, 3)
    s = triangle_setup(torch.from_numpy(clip), vidx, n, w, h, CullMode.NONE)
    ap = None
    if n_attrs:
        ap = cr.attribute_planes(s, torch.from_numpy(
            rng.uniform(-5, 5, (n, 3, n_attrs)).astype(np.float32)))
    prep = cr.prepare_pairs(s, h, w, max_pairs=8192, attr_planes=ap,
                            tri_mat=torch.arange(n, dtype=torch.int32) % 5)
    return prep, w, h


def _scene(kind, n_attrs, seed=0):
    """(prep, width, height, bounds by mode) of a scene."""
    if kind == "stress":
        prep = ss.stress_pairs(seed, n_attrs, n_dense=N_DENSE)
        return prep, ss.WIDTH, ss.HEIGHT, ss.stress_bounds(prep)
    prep, w, h = _random_prep(seed, n_attrs)
    nty, ntx = -(-h // cr.TILE_H), -(-w // cr.TILE_W)
    g = cr.rasterize_cuda(None, h, w, prepared=prep)
    g = g[0] if n_attrs else g
    behind = torch.where(g.tri_id >= 0, g.depth, 2.0)
    far = torch.full((h, w), 0.8)
    front = torch.full((h, w), -1.0)
    return prep, w, h, {
        "peel": cr._tile_bounds((behind, far), h, w, nty, ntx),
        "dual": cr._tile_bounds((front, far), h, w, nty, ntx)}


def _cut(starts, counts, off, m):
    """starts/counts of the chunk [off, off + m) of every tile's span."""
    live = counts > off
    return (torch.where(live, starts + off, starts),
            (counts - off).clamp(0, m).to(torch.int32))


def _n_cuts(counts, m):
    return max(1, -(-int(counts.max()) // m))


@pytest.mark.parametrize("grid", ["dense", "sparse"])
@pytest.mark.parametrize("n_attrs", [0, 4, 8])
@pytest.mark.parametrize("mode", ["single", "peel", "dual"])
@pytest.mark.parametrize("kind", ["stress", "random"])
def test_chunk_merge_equals_the_whole_walk(kind, mode, n_attrs, grid):
    prep, w, h, bounds = _scene(kind, n_attrs)
    b = prep.bins
    ntx = -(-w // cr.TILE_W)
    tile_map = None
    if grid == "sparse":          # one tile short of the covered ones
        tile_map = cr.sparse_tile_map(b.counts,
                                      max(1, int((b.counts > 0).sum()) - 1))
    bd = None if mode == "single" else bounds[mode]
    dual = mode == "dual"

    def walk(starts, counts):
        return cr._raster_tiles_plain(prep.pair_data, starts, counts, ntx,
                                      w, h, 0, n_attrs, bd, tile_map, dual)

    whole = walk(b.starts, b.counts)
    assert (whole[:, 1] >= 0).any()
    for m in CHUNKS:
        parts = [walk(*_cut(b.starts, b.counts, j * m, m))
                 for j in range(_n_cuts(b.counts, m))]
        merged = cr.merge_chunk_planes(parts, n_attrs or 2, dual)
        assert torch.equal(merged, whole), (m, (merged != whole).sum())
        # the sign of a -0.0 depth survives
        assert torch.equal(torch.signbit(merged), torch.signbit(whole))
    if kind == "stress" and mode == "single":
        d = whole[:, 0]
        assert ((d == 0) & torch.signbit(d)).any()   # -0.0 depths won


def test_stress_scene_carries_its_ties():
    """The stress tile needs many items, and its table holds duplicated
    triangles, -0.0 and depth-1.0 fragments, and bounds equal to
    fragment depths that change the peel."""
    prep = ss.stress_pairs(0, 0, n_dense=N_DENSE)
    tile, count = ss.densest_tile(prep)
    assert count >= N_DENSE // 2
    b = prep.bins
    rows = prep.pair_data[int(b.starts[tile]):int(b.starts[tile]) + count]
    assert (torch.signbit(rows[:, 11]) & (rows[:, 11] == 0)).any()
    assert (rows[:, 9:12] == rows[:, 12:15]).all(1).any()   # z == w
    coef = rows[:, :15]
    assert coef.unique(dim=0).shape[0] < count              # duplicates
    ntx = -(-ss.WIDTH // cr.TILE_W)
    bd = ss.stress_bounds(prep)
    args = (prep.pair_data, b.starts, b.counts, ntx, ss.WIDTH, ss.HEIGHT)
    whole = cr._raster_tiles_plain(*args, 0, 0, bd["dual"], dual=True)
    peel = cr._raster_tiles_plain(*args, 0, 0, bd["peel"])
    # the peel between layer 1 (excluded) and layer 2 (included, d == zmax)
    # finds layer 2 exactly
    assert torch.equal(peel, whole[:, 5:])
    assert (peel[:, 1] >= 0).any()


@pytest.mark.parametrize("n_attrs_b", [2, 4])
@pytest.mark.parametrize("kind", ["stress", "random"])
def test_chunk_merge_equals_the_whole_merged_walk(kind, n_attrs_b):
    """K2's items cut the A span followed by the B span; the merged chunks
    fold under the merged opaque depth and equal the whole walk."""
    if kind == "stress":
        pa = ss.stress_pairs(0, 4, n_dense=N_DENSE)
        pb = ss.stress_pairs(1, 4, n_dense=N_DENSE)
        w, h = ss.WIDTH, ss.HEIGHT
    else:
        pa, w, h = _random_prep(2, 4)
        pb, _, _ = _random_prep(3, 4)
    ntx = -(-w // cr.TILE_W)
    a, b = pa.bins, pb.bins

    def walk(sa, ca, sb, cb):
        return cr._merged_tiles_plain(pa.pair_data, sa, ca, pb.pair_data, sb,
                                      cb, ntx, w, h, 0, n_attrs_b)

    whole = walk(a.starts, a.counts, b.starts, b.counts)
    assert (whole[:, 7 + 1] >= 0).any()
    total = a.counts + b.counts
    for m in CHUNKS:
        parts = []
        for j in range(_n_cuts(total, m)):
            lo = torch.tensor(j * m)
            hi = lo + m
            a0, a1 = lo.minimum(a.counts), hi.minimum(a.counts)
            b0 = lo.maximum(a.counts) - a.counts
            b1 = hi.maximum(a.counts) - a.counts
            b1 = b1.minimum(b.counts)
            b0 = b0.minimum(b1)
            parts.append(walk(a.starts + a0, (a1 - a0).to(torch.int32),
                              b.starts + b0, (b1 - b0).to(torch.int32)))
        merged = cr.merge_chunk_merged(parts, n_attrs_b)
        assert torch.equal(merged, whole), (m, (merged != whole).sum())
