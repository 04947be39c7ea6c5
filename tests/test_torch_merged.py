"""K2, the merged raster launch (``cuda_raster.merged_tiles``): its plain
PyTorch version on the CPU.

Tolerances, stated:
- against K1's plain version run as two launches — the opaque winner,
  then the dual peel with bounds (-1, opaque depth) — bit for bit (every
  plane of every tile): the fold's cap equals the peel bound, and both
  walks evaluate the same planes in the same order;
- against the JAX package's ``rasterize_pallas_merged`` in interpret mode,
  fed JAX's setup and attribute planes: tri and material ids exact, depth
  within rtol 2e-5 and attributes within rtol 2e-4 where a layer is drawn
  (the interpreter's planes round with XLA's contraction; the JAX fold
  leaves a capped layer's attributes in place where the port writes 0, and
  ``tests/test_pallas_raster.py`` holds attributes at rtol 2e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderengine_tpu.core.config import CullMode as JCull
from renderengine_tpu.raster import pallas_raster as jpal
from renderengine_tpu.raster import setup as jsetup
from renderengine_tpu.shading import lightchart as jlc
from renderengine_tpu_torch.core.config import CullMode
from renderengine_tpu_torch.raster import cuda_raster as cr
from renderengine_tpu_torch.raster.setup import TriSetup, triangle_setup

torch.set_num_threads(2)


def _clip(rng, n):
    scale = rng.uniform(0.05, 1.0, (n, 1, 1)).astype(np.float32)
    center = rng.uniform(-1.1, 1.1, (n, 1, 2)).astype(np.float32)
    tri = center + scale * rng.uniform(-1, 1, (n, 3, 2)).astype(np.float32)
    z = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    clip = np.concatenate([tri, z[..., None], np.ones((n, 3, 1), np.float32)],
                          axis=-1)
    return clip.reshape(-1, 4), np.arange(3 * n, dtype=np.int32).reshape(n, 3)


def _prep(rng, n, w, h, cull):
    """A random list's setup and 4-attribute pair table with materials."""
    clip, vidx = _clip(rng, n)
    s = triangle_setup(torch.from_numpy(clip), torch.from_numpy(vidx), n, w,
                       h, cull)
    ap = cr.attribute_planes(s, torch.from_numpy(
        rng.uniform(-5, 5, (n, 3, 4)).astype(np.float32)))
    return s, cr.prepare_pairs(s, h, w, max_pairs=8192, attr_planes=ap,
                               tri_mat=torch.from_numpy(
                                   rng.integers(0, 9, n).astype(np.int32)))


CASES = [(64, 48, CullMode.BACK, 16, 12), (53, 37, CullMode.NONE, 24, 20),
         (97, 61, CullMode.BACK, 60, 30), (40, 24, CullMode.NONE, 6, 0)]


@pytest.mark.parametrize("n_attrs_b", [2, 4])
@pytest.mark.parametrize("w,h,cull,n,nb", CASES)
def test_plain_k2_equals_k1_opaque_then_bounded_dual(rng, w, h, cull, n, nb,
                                                     n_attrs_b):
    _, pa = _prep(rng, n, w, h, cull)
    _, pb = _prep(rng, max(nb, 1), w, h, CullMode.NONE)
    if nb == 0:                   # an empty blend list: every tile skips B
        pb.bins.counts.zero_()
    ntx = -(-w // cr.TILE_W)
    out = cr.merged_tiles(pa.pair_data, pa.bins.starts, pa.bins.counts,
                          pb.pair_data, pb.bins.starts, pb.bins.counts, ntx,
                          w, h, n_attrs_b=n_attrs_b)
    opq = cr.raster_tiles(pa.pair_data, pa.bins.starts, pa.bins.counts, ntx,
                          w, h, 0, 4)
    # bounds in tile order: pixels of partial tiles see the same cap
    bounds = torch.stack([torch.full_like(opq[:, 0], -1.0), opq[:, 0]], 1)
    dual = cr.raster_tiles(pb.pair_data, pb.bins.starts, pb.bins.counts, ntx,
                           w, h, 0, 4, bounds, None, True)
    pl = 3 + n_attrs_b
    sep = torch.cat([opq, dual[:, :pl], dual[:, 7:7 + pl]], 1)
    assert out.shape == (opq.shape[0], 7 + 2 * pl, 256)
    assert torch.equal(out, sep)
    assert (out[:, 1] >= 0).any()
    if nb:
        # both blend layers are drawn somewhere, and the cap voids some
        # fragments that the unbounded walk kept
        assert (out[:, 7 + 1] >= 0).any() and (out[:, 7 + pl + 1] >= 0).any()
        free = cr.raster_tiles(pb.pair_data, pb.bins.starts, pb.bins.counts,
                               ntx, w, h, 0, 4, dual=False,
                               bounds=torch.stack(
                                   [torch.full_like(opq[:, 0], -1.0),
                                    torch.full_like(opq[:, 0], 2.0)], 1))
        assert ((free[:, 1] >= 0) & (out[:, 7 + 1] < 0)).any()
    else:
        assert (out[:, 7:, :][:, [0, pl]] == 1.0).all()
        assert (out[:, 7:, :][:, [1, pl + 1]] == -1.0).all()


def test_merged_pass_equals_separate_passes(rng):
    """``rasterize_cuda_merged`` untiles like ``rasterize_cuda``: the same
    G-buffers and attributes as the opaque pass plus the dual peel."""
    w, h = 70, 45
    sa, pa = _prep(rng, 30, w, h, CullMode.BACK)
    sb, pb = _prep(rng, 20, w, h, CullMode.NONE)
    (g, a), layers = cr.rasterize_cuda_merged(h, w, pa, pb, n_attrs_b=2)
    g0, a0 = cr.rasterize_cuda(sa, h, w, prepared=pa)
    assert torch.equal(g.depth, g0.depth) and torch.equal(g.tri_id, g0.tri_id)
    assert torch.equal(g.mat_id, g0.mat_id) and torch.equal(a, a0)
    prev = torch.full((h, w), -1.0)
    sep = cr.rasterize_cuda(sb, h, w, prepared=pb, peel_bounds=(prev, g0.depth),
                            peel_layers=2)
    for (gm, am), (gs, as_) in zip(layers, sep, strict=True):
        assert am.shape == (h, w, 2)
        assert torch.equal(gm.depth, gs.depth)
        assert torch.equal(gm.tri_id, gs.tri_id)
        assert torch.equal(gm.mat_id, gs.mat_id)
        assert torch.equal(am, as_[..., :2])


def test_merged_refuses_what_k2_does_not_take(rng):
    _, p8 = _prep(rng, 4, 32, 16, CullMode.NONE)
    s = p8.pair_data.new_zeros((4, cr._cols_per_pair(8)))
    bad = cr.PreparedPairs(p8.bins, s, True, 8)
    with pytest.raises(ValueError, match="4 attributes"):
        cr.rasterize_cuda_merged(16, 32, bad, p8)
    with pytest.raises(ValueError, match="n_attrs_b"):
        cr.merged_tiles(p8.pair_data, p8.bins.starts, p8.bins.counts,
                        p8.pair_data, p8.bins.starts, p8.bins.counts, 1, 32,
                        16, n_attrs_b=3)
    # a tensor off the CPU goes to the kernel's checks, never the plain path
    meta = p8.pair_data.to("meta")
    st = p8.bins.starts.to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        cr.merged_tiles(meta, st, st, meta, st, st, 1, 32, 16)


def test_plain_k2_counts_each_walk(rng):
    w, h = 64, 32
    _, pa = _prep(rng, 12, w, h, CullMode.NONE)
    _, pb = _prep(rng, 10, w, h, CullMode.NONE)
    ntx = -(-w // cr.TILE_W)
    st = {}
    cr._merged_tiles_plain(pa.pair_data, pa.bins.starts, pa.bins.counts,
                           pb.pair_data, pb.bins.starts, pb.bins.counts, ntx,
                           w, h, 0, 4, stats=st)
    sa, sb = {}, {}
    cr._raster_tiles_plain(pa.pair_data, pa.bins.starts, pa.bins.counts, ntx,
                           w, h, 0, 4, stats=sa)
    cr._raster_tiles_plain(pb.pair_data, pb.bins.starts, pb.bins.counts, ntx,
                           w, h, 0, 4, dual=True, stats=sb)
    assert st == {"wins": sa["wins"], "wins_b": sb["wins"],
                  "demotes": sb["demotes"]}
    assert st["wins"] > 0 and st["wins_b"] > 0 and st["demotes"] > 0


def _jax_prep(rng, n, w, h, cull):
    clip, vidx = _clip(rng, n)
    js = jsetup.triangle_setup(jnp.asarray(clip), jnp.asarray(vidx),
                               jnp.int32(n), w, h, JCull(cull))
    corners = rng.uniform(-5, 5, (n, 3, 4)).astype(np.float32)
    ap = jlc.tss_attribute_planes(js, corner_uv=corners[..., 0:2],
                                  uv_corners=jnp.asarray(corners[..., 2:4]))
    mat = rng.integers(0, 9, n).astype(np.int32)
    jp = jpal.prepare_pallas_pairs(js, h, w, max_pairs=8192, attr_planes=ap,
                                   tri_mat=jnp.asarray(mat))
    ts = TriSetup(*(torch.from_numpy(np.array(x))
                    for x in (js.coef, js.tie, js.valid, js.bbox)))
    tp = cr.prepare_pairs(ts, h, w, max_pairs=8192,
                          attr_planes=torch.from_numpy(np.array(ap)),
                          tri_mat=torch.from_numpy(mat))
    return js, jp, ts, tp


@pytest.mark.parametrize("n_attrs_b", [2, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_k2_matches_jax_merged_kernel(seed, n_attrs_b):
    """At 64x32 on JAX's setup: the JAX kernel in interpret mode."""
    rng = np.random.default_rng(seed)
    w, h = 64, 32
    js, jpa, ts, tpa = _jax_prep(rng, 14, w, h, JCull.BACK)
    _, jpb, _, tpb = _jax_prep(rng, 18, w, h, JCull.NONE)
    jo, jl = jpal.rasterize_pallas_merged(js, h, w, jpa, jpb, interpret=True,
                                          n_attrs_b=n_attrs_b)
    to, tl = cr.rasterize_cuda_merged(h, w, tpa, tpb,
                                      n_attrs_b=n_attrs_b)
    drawn = 0
    for (jg, ja), (tg, ta) in zip([jo] + jl, [to] + tl, strict=True):
        np.testing.assert_array_equal(tg.tri_id.numpy(), np.asarray(jg.tri_id))
        np.testing.assert_array_equal(tg.mat_id.numpy(), np.asarray(jg.mat_id))
        np.testing.assert_allclose(tg.depth.numpy(), np.asarray(jg.depth),
                                   rtol=2e-5, atol=1e-6)
        cov = np.asarray(jg.tri_id) >= 0
        drawn += int(cov.sum())
        jat = np.stack([np.asarray(p) for p in ja], -1)
        assert ta.shape == jat.shape
        np.testing.assert_allclose(ta.numpy()[cov], jat[cov], rtol=2e-4,
                                   atol=2e-4)
    assert drawn > 0 and (tl[0][0].tri_id >= 0).any()
