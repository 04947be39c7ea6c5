"""K1, the tile raster kernel: its plain PyTorch version (what the ``cuda``
backend runs on CPU tensors) against the port's brute-force oracle and
against the JAX package's Pallas kernel in interpret mode. The kernel
itself is held to its plain version on the card in tests/test_torch_gpu.py.

Tolerances, stated: against the port's own oracle, tri ids and depths are
bit-exact (same setup, same plane arithmetic, same tie rule); attributes
match the barycentric resolve within rtol 2e-4 (as
tests/test_pallas_raster.py). Against JAX's Pallas kernel on the SAME
(JAX) setup, tri ids and material ids are exact, depth is within 1e-6
absolute / 2e-5 relative and attributes (values up to 5) within 1e-4,
since XLA may contract the plane multiply-adds into FMAs. The same
tolerances hold in every mode (peel, dual, sparse grid): a peel compares
depths against per-pixel bounds, so its inputs are built with bounds that
no fragment's depth comes within 1e-4 of, and ids stay exact."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from renderengine_tpu.core.config import CullMode as JCull
from renderengine_tpu.raster import pallas_raster as jpal
from renderengine_tpu.raster import setup as jsetup
from renderengine_tpu_torch.core.config import CullMode
from renderengine_tpu_torch.raster import cuda_raster as cr
from renderengine_tpu_torch.raster.reference_raster import (
    barycentrics_at, rasterize_reference)
from renderengine_tpu_torch.raster.setup import (TriSetup, restrict_rows,
                                                 triangle_setup)

torch.set_num_threads(2)


def random_clip(rng, n, front_facing_mix=True):
    """Random triangles in NDC with random depth, some tiny, some large
    (tests/test_tiled.py::random_setup's distribution)."""
    scale = rng.uniform(0.02, 1.0, (n, 1, 1)).astype(np.float32)
    center = rng.uniform(-1.1, 1.1, (n, 1, 2)).astype(np.float32)
    tri = center + scale * rng.uniform(-1, 1, (n, 3, 2)).astype(np.float32)
    z = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    clip = np.concatenate([tri, z[..., None], np.ones((n, 3, 1), np.float32)],
                          axis=-1)
    return clip.reshape(-1, 4), np.arange(3 * n, dtype=np.int32).reshape(n, 3)


def random_setup(rng, n, w, h, cull=CullMode.NONE):
    clip, vidx = random_clip(rng, n)
    return triangle_setup(torch.from_numpy(clip), torch.from_numpy(vidx), n,
                          w, h, cull)


CASES = [(64, 48, CullMode.NONE, 16), (53, 37, CullMode.BACK, 12),
         (97, 61, CullMode.NONE, 60)]


@pytest.mark.parametrize("w,h,cull,n", CASES)
def test_plain_k1_matches_oracle_exactly(rng, w, h, cull, n):
    s = random_setup(rng, n, w, h, cull)
    ref = rasterize_reference(s, h, w)
    g = cr.rasterize_cuda(s, h, w, max_pairs=8192)
    assert torch.equal(g.tri_id, ref.tri_id)
    assert torch.equal(g.depth, ref.depth)
    assert (ref.tri_id >= 0).any()
    # n_attrs=0 carries the barycentric numerators: b_i = E_i / sum(E)
    bary, _ = barycentrics_at(s.coef, ref.tri_id, h, w)
    cov = ref.tri_id >= 0
    np.testing.assert_allclose(g.bary[cov].numpy(), bary[..., :2][cov].numpy(),
                               rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("dense_k", [None, 2])
def test_attrs_match_barycentric_resolve(rng, dense_k):
    w, h, n = 48, 32, 14
    s = random_setup(rng, n, w, h)
    corners = torch.from_numpy(rng.uniform(-5, 5, (n, 3, 8)).astype(np.float32))
    ap = cr.attribute_planes(s, corners)
    tri_mat = torch.from_numpy(rng.integers(0, 9, n).astype(np.int32))
    g, attrs = cr.rasterize_cuda(s, h, w, max_pairs=8192, attr_planes=ap,
                                 tri_mat=tri_mat, dense_k=dense_k)
    ref = rasterize_reference(s, h, w)
    assert torch.equal(g.tri_id, ref.tri_id)
    assert torch.equal(g.depth, ref.depth)
    cov = ref.tri_id >= 0
    bary, _ = barycentrics_at(s.coef, ref.tri_id, h, w)
    golden = (corners[ref.tri_id.clamp_min(0).long()] * bary[..., None]).sum(-2)
    np.testing.assert_allclose(attrs[cov].numpy(), golden[cov].numpy(),
                               rtol=2e-4, atol=2e-4)
    # packed material ids ride the pair rows
    assert torch.equal(g.mat_id[cov], tri_mat[ref.tri_id[cov].long()])
    assert (g.mat_id[~cov] == 0).all()


def test_budget_overflow_reported_not_crashing(rng):
    w, h = 64, 48
    s = random_setup(rng, 24, w, h)
    prep = cr.prepare_pairs(s, h, w, max_pairs=16)
    assert int(prep.bins.n_overflow) > 0
    g = cr.rasterize_cuda(s, h, w, prepared=prep)
    ids = g.tri_id.numpy()
    assert ids.max() < 24 and ids.min() >= -1


@pytest.mark.parametrize("y0,slice_h", [(16, 24), (5, 13)])
def test_row_slice_matches_full_frame(rng, y0, slice_h):
    """A row slice of a taller viewport (``y0``/``full_height``, the
    shadow pass's form) gives the full frame's rows exactly."""
    w, h, n = 53, 48, 20
    s = random_setup(rng, n, w, h)
    full = rasterize_reference(s, h, w)
    g = cr.rasterize_cuda(restrict_rows(s, y0, slice_h, h), slice_h, w,
                          max_pairs=8192, y0=y0, full_height=h)
    assert torch.equal(g.tri_id, full.tri_id[y0:y0 + slice_h])
    assert torch.equal(g.depth, full.depth[y0:y0 + slice_h])
    assert (g.tri_id >= 0).any()


def test_plain_k1_counts_depth_wins(rng):
    """``stats["wins"]`` (the per-winner work a bound counts) equals the
    strict depth improvements of a per-pixel walk over the triangles in
    ascending id order, each triangle rastered alone by the oracle. The
    extent is whole tiles: the plain version also counts the pixels of a
    partial tile that lie outside the image, which the kernel computes."""
    w, h, n = 64, 40, 12
    s = random_setup(rng, n, w, h)
    prep = cr.prepare_pairs(s, h, w, max_pairs=8192)
    stats = {}
    cr._raster_tiles_plain(prep.pair_data, prep.bins.starts, prep.bins.counts,
                           -(-w // cr.TILE_W), w, h, stats=stats)
    best = torch.ones((h, w))
    wins = 0
    for t in range(n):
        one = rasterize_reference(TriSetup(*(f[t:t + 1] for f in s)), h, w)
        take = (one.tri_id >= 0) & (one.depth < best)
        best = torch.where(take, one.depth, best)
        wins += int(take.sum())
    assert stats["wins"] == wins
    assert wins > int((rasterize_reference(s, h, w).tri_id >= 0).sum())


def test_empty_tiles_get_the_clear_block():
    pd = torch.zeros((4, 44))
    starts = torch.zeros(3, dtype=torch.int32)
    counts = torch.zeros(3, dtype=torch.int32)
    out = cr.raster_tiles(pd, starts, counts, 3, 96, 8, n_attrs=8)
    assert (out[:, 0] == 1.0).all() and (out[:, 1] == -1.0).all()
    assert (out[:, 2:] == 0.0).all()


@pytest.mark.parametrize("w,h,cull,n,n_attrs", [
    (40, 24, CullMode.NONE, 10, 8), (37, 21, CullMode.BACK, 10, 0)])
def test_plain_k1_matches_jax_pallas(rng, w, h, cull, n, n_attrs):
    clip, vidx = random_clip(rng, n)
    js = jsetup.triangle_setup(jnp.asarray(clip), jnp.asarray(vidx),
                               jnp.int32(n), w, h, JCull(cull))
    ts = TriSetup(*(torch.from_numpy(np.array(x))
                    for x in (js.coef, js.tie, js.valid, js.bbox)))
    tri_mat = rng.integers(0, 7, n).astype(np.int32)
    kw = {}
    if n_attrs:
        corners = rng.uniform(-5, 5, (n, 3, 8)).astype(np.float32)
        kw = dict(attr_planes=jpal.attribute_planes(
            js, corners=jnp.asarray(corners)))
    jout = jpal.rasterize_pallas(js, h, w, max_pairs=8192, interpret=True,
                                 tri_mat=jnp.asarray(tri_mat), **kw)
    if n_attrs:
        kw = dict(attr_planes=torch.from_numpy(np.array(kw["attr_planes"])))
    tout = cr.rasterize_cuda(ts, h, w, max_pairs=8192,
                             tri_mat=torch.from_numpy(tri_mat), **kw)
    jg, ja = jout if n_attrs else (jout, None)
    tg, ta = tout if n_attrs else (tout, None)
    np.testing.assert_array_equal(tg.tri_id.numpy(), np.asarray(jg.tri_id))
    np.testing.assert_array_equal(tg.mat_id.numpy(), np.asarray(jg.mat_id))
    np.testing.assert_allclose(tg.depth.numpy(), np.asarray(jg.depth),
                               rtol=2e-5, atol=1e-6)
    if n_attrs:
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-4,
                                   atol=1e-4)
    else:
        cov = np.asarray(jg.tri_id) >= 0
        np.testing.assert_allclose(tg.bary.numpy()[cov],
                                   np.asarray(jg.bary)[cov], rtol=2e-5,
                                   atol=1e-6)


# --- peel, dual and the sparse grid ------------------------------------------

def _peel_inputs(rng, n, w, h, n_attrs, cull=CullMode.NONE):
    s = random_setup(rng, n, w, h, cull)
    ap = None
    if n_attrs:
        ap = cr.attribute_planes(s, torch.from_numpy(
            rng.uniform(-5, 5, (n, 3, 8)).astype(np.float32)))
    tri_mat = torch.from_numpy(rng.integers(0, 5, n).astype(np.int32))
    prep = cr.prepare_pairs(s, h, w, max_pairs=8192, attr_planes=ap,
                            tri_mat=tri_mat)
    return s, prep


def _layers(out, n_attrs):
    """rasterize_cuda's result as [(GBuffer, attrs-or-None), ...]."""
    if isinstance(out, list):
        return out
    return [out if n_attrs else (out, None)]


def _assert_layers_equal(a, b):
    for (ga, aa), (gb, ab) in zip(a, b, strict=True):
        assert torch.equal(ga.tri_id, gb.tri_id)
        assert torch.equal(ga.depth, gb.depth)
        assert torch.equal(ga.mat_id, gb.mat_id)
        if aa is None:
            assert torch.equal(ga.bary, gb.bary)
        else:
            assert torch.equal(aa, ab)


@pytest.mark.parametrize("n_attrs", [0, 8])
@pytest.mark.parametrize("w,h,cull,n", CASES)
def test_plain_k1_peel_matches_oracle_exactly(rng, w, h, cull, n, n_attrs):
    """Two successive peels under the opaque depth: ids and depths equal
    ``rasterize_reference(peel_bounds=)`` bit for bit, odd extents
    included (pixels of a partial tile outside the image never cover)."""
    s, prep = _peel_inputs(rng, n, w, h, n_attrs, cull)
    zmax = rasterize_reference(s, h, w).depth
    prev = torch.full((h, w), -1.0)
    seen = 0
    for _ in range(2):
        ref = rasterize_reference(s, h, w, peel_bounds=(prev, zmax))
        g = _layers(cr.rasterize_cuda(s, h, w, prepared=prep,
                                      peel_bounds=(prev, zmax)), n_attrs)[0][0]
        assert torch.equal(g.tri_id, ref.tri_id)
        assert torch.equal(g.depth, ref.depth)
        seen += int((ref.tri_id >= 0).sum())
        prev = torch.where(g.tri_id >= 0, g.depth, 2.0)
    assert seen > 0


@pytest.mark.parametrize("active", [None, "covered"])
@pytest.mark.parametrize("n_attrs", [0, 8])
def test_dual_equals_two_single_peels(rng, n_attrs, active):
    """``peel_layers=2`` == two successive single-peel launches bit for
    bit: both layers' ids, depths, material ids and attributes (or
    barycentrics), on the dense grid and on a sparse grid that holds every
    covered tile."""
    w, h, n = 64, 48, 16
    s, prep = _peel_inputs(rng, n, w, h, n_attrs)
    k = (None if active is None
         else max(1, int((prep.bins.counts > 0).sum())))
    b0 = (torch.full((h, w), -1.0), torch.ones((h, w)))
    one = _layers(cr.rasterize_cuda(s, h, w, prepared=prep, peel_bounds=b0),
                  n_attrs)[0]
    prev2 = torch.where(one[0].tri_id >= 0, one[0].depth, 2.0)
    two = _layers(cr.rasterize_cuda(s, h, w, prepared=prep,
                                    peel_bounds=(prev2, b0[1])), n_attrs)[0]
    dual = cr.rasterize_cuda(s, h, w, prepared=prep, peel_bounds=b0,
                             peel_layers=2, active_tiles=k)
    _assert_layers_equal(dual, [one, two])
    assert (two[0].tri_id >= 0).any()
    # a second layer with no winner reads the clear values
    empty = two[0].tri_id < 0
    assert (dual[1][0].depth[empty] == 1.0).all()
    assert (dual[1][0].mat_id[empty] == 0).all()


def test_dual_keeps_equal_depth_out_of_layer_two():
    """Two coplanar copies of one triangle: the lower id wins layer 1 and
    the copy, equal in depth, enters neither layer."""
    clip = np.array([[-0.8, -0.8, 0.5, 1], [0.8, -0.8, 0.5, 1],
                     [0.0, 0.8, 0.5, 1]] * 2, np.float32)
    vidx = np.arange(6, dtype=np.int32).reshape(2, 3)
    w, h = 64, 32
    s = triangle_setup(torch.from_numpy(clip), torch.from_numpy(vidx), 2, w,
                       h, CullMode.NONE)
    b0 = (torch.full((h, w), -1.0), torch.ones((h, w)))
    (g1, _), (g2, _) = cr.rasterize_cuda(s, h, w, max_pairs=1024,
                                         peel_bounds=b0, peel_layers=2)
    assert set(g1.tri_id.unique().tolist()) == {-1, 0}
    assert (g2.tri_id == -1).all() and (g2.depth == 1.0).all()


@pytest.mark.parametrize("mode", ["single", "peel", "dual"])
def test_sparse_grid_equals_dense_when_k_suffices(rng, mode):
    w, h, n = 64, 48, 12
    s, prep = _peel_inputs(rng, n, w, h, 8)
    k = max(1, int((prep.bins.counts > 0).sum()))
    assert k < prep.bins.counts.shape[0]
    kw = {}
    if mode != "single":
        kw = dict(peel_bounds=(torch.full((h, w), -1.0), torch.ones((h, w))),
                  peel_layers=2 if mode == "dual" else 1)
    dense = _layers(cr.rasterize_cuda(s, h, w, prepared=prep, **kw), 8)
    sparse = _layers(cr.rasterize_cuda(s, h, w, prepared=prep,
                                       active_tiles=k, **kw), 8)
    _assert_layers_equal(sparse, dense)


def test_sparse_grid_drops_tiles_beyond_k(rng):
    """With K too small the kept tiles are the stable top-K by pair count
    (ties to the lowest tile index), equal to the dense result there; every
    other tile reads the clear block in both layers."""
    w, h, n = 97, 61, 60
    s, prep = _peel_inputs(rng, n, w, h, 8)
    counts = prep.bins.counts
    k = int((counts > 0).sum()) // 2
    kept = cr.sparse_tile_map(counts, k)
    # the K-th and (K+1)-th counts tie in this case: the map must break it
    order = np.argsort(-counts.numpy(), kind="stable")
    assert counts[order[k - 1]] == counts[order[k]]
    np.testing.assert_array_equal(kept.numpy(), np.sort(order[:k]))
    b0 = (torch.full((h, w), -1.0), torch.ones((h, w)))
    dense = cr.rasterize_cuda(s, h, w, prepared=prep, peel_bounds=b0,
                              peel_layers=2)
    sparse = cr.rasterize_cuda(s, h, w, prepared=prep, peel_bounds=b0,
                               peel_layers=2, active_tiles=k)
    ntx = -(-w // cr.TILE_W)
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    tile_of = (ys // cr.TILE_H) * ntx + xs // cr.TILE_W
    in_kept = torch.isin(tile_of, kept.long())
    dropped = 0
    for (gd, ad), (gs, as_) in zip(dense, sparse):
        assert torch.equal(gs.tri_id[in_kept], gd.tri_id[in_kept])
        assert torch.equal(gs.depth[in_kept], gd.depth[in_kept])
        assert torch.equal(as_[in_kept], ad[in_kept])
        assert (gs.tri_id[~in_kept] == -1).all()
        assert (gs.depth[~in_kept] == 1.0).all()
        assert (gs.mat_id[~in_kept] == 0).all()
        assert (as_[~in_kept] == 0.0).all()
        dropped += int((gd.tri_id[~in_kept] >= 0).sum())
    assert dropped > 0


def test_sparse_tile_map_breaks_ties_to_the_lowest_tile():
    counts = torch.tensor([5, 7, 7, 3, 7, 5], dtype=torch.int32)
    assert cr.sparse_tile_map(counts, 2).tolist() == [1, 2]
    assert cr.sparse_tile_map(counts, 4).tolist() == [0, 1, 2, 4]
    assert cr.sparse_tile_map(counts, 4).dtype == torch.int32


def test_dual_without_bounds_raises(rng):
    s, prep = _peel_inputs(rng, 6, 32, 16, 0)
    with pytest.raises(ValueError, match="requires peel_bounds"):
        cr.rasterize_cuda(s, 16, 32, prepared=prep, peel_layers=2)
    b = prep.bins
    with pytest.raises(ValueError, match="requires peel bounds"):
        cr.raster_tiles(prep.pair_data, b.starts, b.counts, 1, 32, 16,
                        dual=True)
    with pytest.raises(ValueError, match="peel_layers must be"):
        cr.rasterize_cuda(s, 16, 32, prepared=prep, peel_layers=3)


def test_tile_bounds_pad_so_nothing_passes():
    """Pixels of a partial tile outside the image get prev 2.0 / zmax -1.0."""
    h, w = 10, 40
    prev = torch.full((h, w), 0.25)
    zmax = torch.full((h, w), 0.75)
    tb = cr._tile_bounds((prev, zmax), h, w, 2, 2)
    assert tb.shape == (4, 2, 256) and tb.is_contiguous()
    t3 = tb[3].reshape(2, cr.TILE_H, cr.TILE_W)        # rows 8.., cols 32..
    assert (t3[0, :2, :8] == 0.25).all() and (t3[1, :2, :8] == 0.75).all()
    assert (t3[0, 2:] == 2.0).all() and (t3[0, :, 8:] == 2.0).all()
    assert (t3[1, 2:] == -1.0).all() and (t3[1, :, 8:] == -1.0).all()


def test_plain_k1_counts_layer_entries_and_demotions(rng):
    """In a dual walk ``stats`` counts every fragment that entered a layer
    and, of those, the layer-1 entries (each pushes the old layer 1 down):
    with bounds that pass everything, the layer-1 entries equal the single
    walk's depth wins."""
    w, h, n = 64, 40, 12
    s, prep = _peel_inputs(rng, n, w, h, 0)
    b = prep.bins
    ntx = -(-w // cr.TILE_W)
    single, dual = {}, {}
    cr._raster_tiles_plain(prep.pair_data, b.starts, b.counts, ntx, w, h,
                           stats=single)
    bounds = cr._tile_bounds((torch.full((h, w), -1.0), torch.ones((h, w))),
                             h, w, -(-h // cr.TILE_H), ntx)
    cr._raster_tiles_plain(prep.pair_data, b.starts, b.counts, ntx, w, h,
                           bounds=bounds, dual=True, stats=dual)
    assert dual["demotes"] == single["wins"]
    assert dual["wins"] > dual["demotes"]
    assert single["demotes"] == 0


JAX_MODES = ["peel", "dual", "dual_sparse", "single_sparse"]


@pytest.mark.parametrize("mode", JAX_MODES)
@pytest.mark.parametrize("w,h,cull,n,n_attrs", [
    (40, 24, CullMode.NONE, 10, 8), (37, 21, CullMode.NONE, 14, 0)])
def test_plain_k1_modes_match_jax_pallas(rng, w, h, cull, n, n_attrs, mode):
    """Peel, dual and the sparse grid against the JAX package's kernel in
    interpret mode, on JAX's setup and the same bounds."""
    clip, vidx = random_clip(rng, n)
    js = jsetup.triangle_setup(jnp.asarray(clip), jnp.asarray(vidx),
                               jnp.int32(n), w, h, JCull(cull))
    ts = TriSetup(*(torch.from_numpy(np.array(x))
                    for x in (js.coef, js.tie, js.valid, js.bbox)))
    tri_mat = rng.integers(0, 7, n).astype(np.int32)
    jkw, tkw = {}, {}
    if n_attrs:
        corners = rng.uniform(-5, 5, (n, 3, 8)).astype(np.float32)
        jkw["attr_planes"] = jpal.attribute_planes(
            js, corners=jnp.asarray(corners))
        tkw["attr_planes"] = torch.from_numpy(np.array(jkw["attr_planes"]))
    if mode != "single_sparse":
        # bounds clear of every fragment depth (z lies in [0.05, 0.95] and
        # the far bound sits 1 above it), so no compare hangs on the last bit
        prev = np.full((h, w), -1.0, np.float32)
        if mode == "peel":      # peel past the port's own first layer
            first = _layers(cr.rasterize_cuda(ts, h, w, max_pairs=8192,
                                              **tkw), n_attrs)[0][0]
            prev = np.where(first.tri_id.numpy() >= 0,
                            first.depth.numpy() + 1e-4, 2.0).astype(np.float32)
        zmax = np.full((h, w), 1.95, np.float32)
        jkw["peel_bounds"] = (jnp.asarray(prev), jnp.asarray(zmax))
        tkw["peel_bounds"] = (torch.from_numpy(prev), torch.from_numpy(zmax))
        if mode.startswith("dual"):
            jkw["peel_layers"] = tkw["peel_layers"] = 2
    if mode.endswith("sparse"):
        jprep = jpal.prepare_pallas_pairs(js, h, w, max_pairs=8192)
        k = max(1, int(np.asarray((jprep.bins.counts > 0).sum())) - 1)
        jkw["active_tiles"] = tkw["active_tiles"] = k
    jout = jpal.rasterize_pallas(js, h, w, max_pairs=8192, interpret=True,
                                 tri_mat=jnp.asarray(tri_mat), **jkw)
    tout = cr.rasterize_cuda(ts, h, w, max_pairs=8192,
                             tri_mat=torch.from_numpy(tri_mat), **tkw)
    jl = jout if isinstance(jout, list) else [jout if n_attrs else (jout, None)]
    seen = 0
    for (jg, ja), (tg, ta) in zip(jl, _layers(tout, n_attrs), strict=True):
        np.testing.assert_array_equal(tg.tri_id.numpy(), np.asarray(jg.tri_id))
        np.testing.assert_array_equal(tg.mat_id.numpy(), np.asarray(jg.mat_id))
        np.testing.assert_allclose(tg.depth.numpy(), np.asarray(jg.depth),
                                   rtol=2e-5, atol=1e-6)
        cov = np.asarray(jg.tri_id) >= 0
        seen += int(cov.sum())
        if n_attrs:
            np.testing.assert_allclose(ta.numpy()[cov], np.asarray(ja)[cov],
                                       rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_allclose(tg.bary.numpy()[cov],
                                       np.asarray(jg.bary)[cov], rtol=2e-5,
                                       atol=1e-6)
    assert seen > 0
