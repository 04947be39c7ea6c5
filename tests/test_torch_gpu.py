"""Tests of the port that need a CUDA card: K1 and K2 (both in
``csrc/raster_tile.cu``), the tiered anisotropic sampler
(``csrc/aniso_slots.cu``), the texture-space peel pass
(``csrc/tss_peel.cu``) and the factored texture-space screen pass
(``csrc/tss_shade.cu``) against their plain PyTorch versions, and golden
and texture-space frames rendered through the kernels. They skip
without a card. This file imports no JAX, so it
also runs where only PyTorch is installed:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Tolerance, stated: the kernel equals its plain version bit for bit (tri
ids, material ids, depths and attributes, in every mode: single winner,
peel, dual, each on the dense and the sparse grid; K2 with 2 and 4 blend
attributes): both evaluate every plane as
(a*px + b*py) + c with IEEE rounding and no contraction, divide with IEEE
division and select the same fragments (the kernels split a dense tile's
walk into work items and merge them exactly; the stress-scene cases hold
that, ties included). The sampler kernel equals its plain version bit for
bit too (every multiply, add, divide and square root rounded on its own,
the same integer arithmetic), and the per-pixel frame through it equals
the frame through the plain sampler byte for byte. So does the peel
pass's kernel (its ``/ 255`` is PyTorch's CUDA multiply by the
reciprocal), and the texture-space frame through it the frame through
its plain version; so does the screen pass's kernel (its sRGB decode's
``/ 1.055`` is the multiply by the double reciprocal rounded to float,
its pow the same ``powf``) and the frame through it."""

import numpy as np
import pytest
import torch

import aniso_inputs as ai

from renderengine_tpu_torch.core.config import CullMode, RenderConfig
from renderengine_tpu_torch.graph import frame as fr
from renderengine_tpu_torch.graph.frame import FrameRenderer
from renderengine_tpu_torch.graph.render_loop import RenderLoop
from renderengine_tpu_torch.scene import procedural
from renderengine_tpu_torch.raster import cuda_raster as cr
from renderengine_tpu_torch.raster.setup import restrict_rows, triangle_setup
from renderengine_tpu_torch.shading import lightchart as lc
from renderengine_tpu_torch.shading import sampling
from renderengine_tpu_torch.tools import goldens
from renderengine_tpu_torch.tools import split_stress as ss
from renderengine_tpu_torch.utils import profiling

torch.set_num_threads(2)

CASES = [(64, 48, CullMode.NONE, 16), (53, 37, CullMode.BACK, 12),
         (97, 61, CullMode.NONE, 60)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 is CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _random_setup(rng, n, w, h, cull):
    scale = rng.uniform(0.02, 1.0, (n, 1, 1)).astype(np.float32)
    center = rng.uniform(-1.1, 1.1, (n, 1, 2)).astype(np.float32)
    tri = center + scale * rng.uniform(-1, 1, (n, 3, 2)).astype(np.float32)
    z = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    clip = np.concatenate([tri, z[..., None], np.ones((n, 3, 1), np.float32)],
                          axis=-1).reshape(-1, 4)
    vidx = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    return triangle_setup(torch.from_numpy(clip), torch.from_numpy(vidx), n,
                          w, h, cull)


def _bounds(mode, prep, s, w, h):
    """Peel bounds of a mode as a tile table: ``peel`` peels past the
    nearest layer under a far bound of 0.8, ``dual`` starts in front of
    everything."""
    if mode == "single":
        return None
    nty, ntx = -(-h // cr.TILE_H), -(-w // cr.TILE_W)
    prev = torch.full((h, w), -1.0)
    if mode.startswith("peel"):
        g = cr.rasterize_cuda(s, h, w, prepared=prep)
        g = g[0] if prep.n_attrs else g
        prev = torch.where(g.tri_id >= 0, g.depth, 2.0)
    return cr._tile_bounds((prev, torch.full((h, w), 0.8)), h, w, nty, ntx)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["single", "peel", "dual", "single_sparse",
                                  "peel_sparse", "dual_sparse"])
@pytest.mark.parametrize("n_attrs", [0, 4, 8])
@pytest.mark.parametrize("w,h,cull,n", CASES)
def test_kernel_matches_plain_on_card(cuda_device, w, h, cull, n, n_attrs,
                                      mode):
    rng = np.random.default_rng(0)
    s = _random_setup(rng, n, w, h, cull)
    ap = None
    if n_attrs:
        ap = cr.attribute_planes(s, torch.from_numpy(
            rng.uniform(-5, 5, (n, 3, n_attrs)).astype(np.float32)))
    prep = cr.prepare_pairs(s, h, w, max_pairs=8192, attr_planes=ap,
                            tri_mat=torch.arange(n, dtype=torch.int32) % 5)
    b = prep.bins
    ntx = -(-w // cr.TILE_W)
    base = mode.split("_")[0]
    bounds = _bounds(base, prep, s, w, h)
    tile_map = None
    if mode.endswith("sparse"):      # one tile short of the covered ones
        k = max(1, int((b.counts > 0).sum()) - 1)
        tile_map = cr.sparse_tile_map(b.counts, k)
    dual = base == "dual"
    plain = cr.raster_tiles(prep.pair_data, b.starts, b.counts, ntx, w, h,
                            n_attrs=n_attrs, bounds=bounds, tile_map=tile_map,
                            dual=dual)
    before = cr.launch_counts["raster_tile"]
    on = lambda t: None if t is None else t.to(cuda_device)  # noqa: E731
    kern = cr.raster_tiles(on(prep.pair_data), on(b.starts), on(b.counts),
                           ntx, w, h, n_attrs=n_attrs, bounds=on(bounds),
                           tile_map=on(tile_map), dual=dual)
    torch.cuda.synchronize()
    assert cr.launch_counts["raster_tile"] == before + 1
    assert torch.equal(kern.cpu(), plain)
    if cull == CullMode.NONE:     # the back-culled case has one layer only
        assert (plain[:, 1] >= 0).any()


@pytest.mark.gpu
def test_kernel_row_slice_matches_plain(cuda_device):
    """Rows [5, 18) of a 48-row viewport: the kernel's y0 path."""
    rng = np.random.default_rng(1)
    w, h, y0, sh = 53, 48, 5, 13
    s = restrict_rows(_random_setup(rng, 20, w, h, CullMode.NONE), y0, sh, h)
    prep = cr.prepare_pairs(s, sh, w, max_pairs=8192)
    b = prep.bins
    ntx = -(-w // cr.TILE_W)
    plain = cr.raster_tiles(prep.pair_data, b.starts, b.counts, ntx, w, h, y0)
    kern = cr.raster_tiles(prep.pair_data.to(cuda_device),
                           b.starts.to(cuda_device), b.counts.to(cuda_device),
                           ntx, w, h, y0)
    torch.cuda.synchronize()
    assert torch.equal(kern.cpu(), plain)
    assert (plain[:, 1] >= 0).any()


@pytest.mark.gpu
def test_kernel_refuses_bad_inputs(cuda_device):
    pd = torch.zeros((4, 44), device=cuda_device)
    st = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        cr.raster_tiles(pd, st, st, 2, 64, 8, n_attrs=0)      # 44 != 20 cols
    with pytest.raises(TypeError):
        cr.raster_tiles(pd, st.long(), st, 2, 64, 8, n_attrs=8)
    with pytest.raises(ValueError, match="requires peel bounds"):
        cr.raster_tiles(pd, st, st, 2, 64, 8, n_attrs=8, dual=True)
    with pytest.raises(ValueError, match="bounds must be"):
        cr.raster_tiles(pd, st, st, 2, 64, 8, n_attrs=8,
                        bounds=torch.zeros((3, 2, 256), device=cuda_device))
    with pytest.raises(TypeError, match="tile_map"):
        cr.raster_tiles(pd, st, st, 2, 64, 8, n_attrs=8,
                        tile_map=st.long())


@pytest.mark.gpu
def test_golden_frame_through_the_kernel(cuda_device):
    name, factory, cfg = goldens.golden_cases()[2]     # bindless_textures
    # the renderer captures its frame at init (after one warm-up frame,
    # whose launch counts); render() replays it: one more launch
    r = FrameRenderer(factory(), cfg, device=cuda_device)
    before = cr.launch_counts["raster_tile"]
    img, st = r.render()
    assert cr.launch_counts["raster_tile"] == before + 1
    assert int(st["pair_overflow"]) == 0
    frac, mx = goldens.golden_bar(img.cpu().numpy(), goldens.load_golden(name))
    assert goldens.meets_bar(frac, mx), (frac, mx)


def _prep4(rng, s, w, h):
    """Pairs of a random setup with 4 random attributes and material ids."""
    t = s.coef.shape[0]
    ap = cr.attribute_planes(s, torch.from_numpy(
        rng.uniform(-5, 5, (t, 3, 4)).astype(np.float32)))
    return cr.prepare_pairs(s, h, w, max_pairs=8192, attr_planes=ap,
                            tri_mat=torch.arange(t, dtype=torch.int32) % 7)


@pytest.mark.gpu
@pytest.mark.parametrize("n_attrs_b", [2, 4])
@pytest.mark.parametrize("w,h,cull,n", CASES)
def test_merged_kernel_matches_plain_on_card(cuda_device, w, h, cull, n,
                                             n_attrs_b):
    """K2 over an opaque and a translucent table of random triangles."""
    rng = np.random.default_rng(2)
    pa = _prep4(rng, _random_setup(rng, n, w, h, cull), w, h)
    pb = _prep4(rng, _random_setup(rng, n, w, h, CullMode.NONE), w, h)
    ntx = -(-w // cr.TILE_W)
    tabs = [pa.pair_data, pa.bins.starts, pa.bins.counts,
            pb.pair_data, pb.bins.starts, pb.bins.counts]
    plain = cr.merged_tiles(*tabs, ntx, w, h, n_attrs_b=n_attrs_b)
    before = cr.launch_counts["merged_tile"]
    kern = cr.merged_tiles(*[t.to(cuda_device) for t in tabs], ntx, w, h,
                           n_attrs_b=n_attrs_b)
    torch.cuda.synchronize()
    assert cr.launch_counts["merged_tile"] == before + 1
    assert torch.equal(kern.cpu(), plain)
    assert (plain[:, 7 + 1] >= 0).any()          # blend layer 1 drawn


@pytest.mark.gpu
def test_merged_kernel_refuses_bad_inputs(cuda_device):
    pd = torch.zeros((4, 32), device=cuda_device)
    st = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="n_attrs_b"):
        cr.merged_tiles(pd, st, st, pd, st, st, 2, 64, 8, n_attrs_b=3)
    with pytest.raises(ValueError, match="32"):
        cr.merged_tiles(pd[:, :20], st, st, pd, st, st, 2, 64, 8)
    with pytest.raises(TypeError):
        cr.merged_tiles(pd, st.long(), st, pd, st, st, 2, 64, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["factored", "preshaded", "preshaded_blend"])
def test_tss_frame_through_the_kernels(cuda_device, mode):
    """A texture-space frame with sky and translucency on the card: one K2
    launch, no K1 launch outside the shadow pass; within the golden bar
    of the same frame on the CPU (plain versions). Light tables are
    sampled per pixel (``tss_halfres_light=0``): the half-res upsample's
    discrete same-surface test is not robust to the last bit (ROADMAP.md
    Queue 3 F7)."""
    name, factory, cfg = goldens.golden_cases()[4]      # skybox_full
    flag = {"factored": {}, "preshaded": {"tss_preshaded": True},
            "preshaded_blend": {"tss_preshaded_blend": True}}[mode]
    cfg = cfg.replace(texture_space=True, debug_views=False,
                      tss_halfres_light=0, **flag)
    r = FrameRenderer(factory(), cfg, device=cuda_device)
    before = dict(cr.launch_counts)
    img, st = r.render()
    torch.cuda.synchronize()
    assert cr.launch_counts["merged_tile"] == before["merged_tile"] + 1
    assert cr.launch_counts["raster_tile"] == before["raster_tile"] \
        + r.n_shadows
    assert not any(int(v) for k, v in st.items() if "overflow" in k)
    ref, _ = FrameRenderer(factory(), cfg, device="cpu").render()
    frac, mx = goldens.golden_bar(img.cpu().numpy(), ref.numpy())
    assert goldens.meets_bar(frac, mx), (frac, mx)


def _stress_dense(cuda_device):
    """Triangles in the stress tile: enough for at least 8 work items."""
    return 8 * cr._library().item_pairs + 64


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["single", "peel", "dual", "single_sparse",
                                  "peel_sparse", "dual_sparse", "single_y0",
                                  "dual_y0"])
@pytest.mark.parametrize("n_attrs", [0, 4, 8])
def test_kernel_splits_a_dense_tile_exactly(cuda_device, n_attrs, mode):
    """The stress scene: one tile of hundreds of pairs (>= 8 work items)
    with duplicated triangles at equal depth, -0.0 and depth-1.0 fragments
    and peel bounds equal to fragment depths; also on the sparse grid and
    on a row slice (y0 = 8)."""
    base = mode.split("_")[0]
    y0, sh = (8, 32) if mode.endswith("y0") else (0, None)
    prep = ss.stress_pairs(0, n_attrs, n_dense=_stress_dense(cuda_device),
                           y0=y0, slice_h=sh)
    b = prep.bins
    _, count = ss.densest_tile(prep)
    assert count > 8 * cr._library().item_pairs
    bounds = None if base == "single" else ss.stress_bounds(prep, y0)[base]
    tile_map = None
    if mode.endswith("sparse"):
        tile_map = cr.sparse_tile_map(b.counts,
                                      max(1, int((b.counts > 0).sum()) - 1))
    args = (ss.WIDTH // cr.TILE_W, ss.WIDTH, ss.HEIGHT, y0, n_attrs)
    plain = cr.raster_tiles(prep.pair_data, b.starts, b.counts, *args,
                            bounds=bounds, tile_map=tile_map,
                            dual=base == "dual")
    on = lambda t: None if t is None else t.to(cuda_device)  # noqa: E731
    kern = cr.raster_tiles(on(prep.pair_data), on(b.starts), on(b.counts),
                           *args, bounds=on(bounds), tile_map=on(tile_map),
                           dual=base == "dual")
    torch.cuda.synchronize()
    assert torch.equal(kern.cpu(), plain)
    assert torch.equal(torch.signbit(kern.cpu()), torch.signbit(plain))
    assert (plain[:, 1] >= 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("n_attrs_b", [2, 4])
def test_merged_kernel_splits_a_dense_tile_exactly(cuda_device, n_attrs_b):
    n = _stress_dense(cuda_device)
    pa = ss.stress_pairs(0, 4, n_dense=n)
    pb = ss.stress_pairs(1, 4, n_dense=n)
    tabs = [pa.pair_data, pa.bins.starts, pa.bins.counts,
            pb.pair_data, pb.bins.starts, pb.bins.counts]
    args = (ss.WIDTH // cr.TILE_W, ss.WIDTH, ss.HEIGHT, 0, n_attrs_b)
    plain = cr.merged_tiles(*tabs, *args)
    kern = cr.merged_tiles(*[t.to(cuda_device) for t in tabs], *args)
    torch.cuda.synchronize()
    assert torch.equal(kern.cpu(), plain)
    assert torch.equal(torch.signbit(kern.cpu()), torch.signbit(plain))
    assert (plain[:, 7 + 1] >= 0).any()


@pytest.mark.gpu
def test_wrappers_make_no_host_sync(cuda_device):
    """raster_tiles and merged_tiles size the split walk from shapes alone:
    no device value is read on the host."""
    prep = ss.stress_pairs(0, 4, n_dense=_stress_dense(cuda_device),
                           device=cuda_device)
    b = prep.bins
    bounds = ss.stress_bounds(prep)["dual"]
    tile_map = cr.sparse_tile_map(b.counts, 8)
    args = (ss.WIDTH // cr.TILE_W, ss.WIDTH, ss.HEIGHT, 0, 4)
    cr.raster_tiles(prep.pair_data, b.starts, b.counts, *args)   # loads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cr.raster_tiles(prep.pair_data, b.starts, b.counts, *args)
        cr.raster_tiles(prep.pair_data, b.starts, b.counts, *args,
                        bounds=bounds, tile_map=tile_map, dual=True)
        cr.merged_tiles(prep.pair_data, b.starts, b.counts, prep.pair_data,
                        b.starts, b.counts, *args[:4], n_attrs_b=2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_kernel_refuses_a_misaligned_table(cuda_device):
    pd = torch.zeros((9, 20), device=cuda_device).view(-1)[1:161]
    st = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        cr.raster_tiles(pd.view(8, 20), st, st, 2, 64, 8)


@pytest.mark.gpu
def test_launches_leave_the_workspace_clean(cuda_device):
    """K1 and K2 share the device's workspace and leave its counters at
    0: the same split launches repeated, in turns, keep equal to their
    plain versions."""
    n = _stress_dense(cuda_device)
    pa = ss.stress_pairs(0, 4, n_dense=n, device=cuda_device)
    pb = ss.stress_pairs(1, 4, n_dense=n, device=cuda_device)
    a, b = pa.bins, pb.bins
    args = (ss.WIDTH // cr.TILE_W, ss.WIDTH, ss.HEIGHT, 0)
    k1 = lambda: cr.raster_tiles(pa.pair_data, a.starts, a.counts,  # noqa
                                 *args, 4)
    k2 = lambda: cr.merged_tiles(pa.pair_data, a.starts, a.counts,  # noqa
                                 pb.pair_data, b.starts, b.counts, *args, 2)
    want1 = cr._raster_tiles_plain(pa.pair_data, a.starts, a.counts, *args, 4)
    want2 = cr._merged_tiles_plain(pa.pair_data, a.starts, a.counts,
                                   pb.pair_data, b.starts, b.counts, *args, 2)
    for fn, want in [(k1, want1), (k1, want1), (k2, want2), (k1, want1),
                     (k2, want2), (k2, want2)]:
        assert torch.equal(fn(), want)


def _stress_k2(cuda_device):
    """The stress scene's K2 launch and its plain result."""
    n = _stress_dense(cuda_device)
    pa = ss.stress_pairs(0, 4, n_dense=n, device=cuda_device)
    pb = ss.stress_pairs(1, 4, n_dense=n, device=cuda_device)
    tabs = (pa.pair_data, pa.bins.starts, pa.bins.counts, pb.pair_data,
            pb.bins.starts, pb.bins.counts, ss.WIDTH // cr.TILE_W, ss.WIDTH,
            ss.HEIGHT, 0, 2)
    return (lambda: cr.merged_tiles(*tabs)), cr._merged_tiles_plain(*tabs)


@pytest.mark.gpu
def test_replayed_launches_start_clean(cuda_device):
    """A launch captured in a CUDA graph replays from the counters the
    last launch left, so replays and launches outside the graph, in
    turns, keep equal to the plain version."""
    k2, want = _stress_k2(cuda_device)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        k2()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            got = k2()
    for _ in range(3):
        graph.replay()
        assert torch.equal(got, want)
        assert torch.equal(k2(), want)


@pytest.mark.gpu
def test_launches_on_two_streams(cuda_device):
    """Launches that alternate between two streams share the device's
    workspace: each is ordered after the other stream's work."""
    k2, want = _stress_k2(cuda_device)
    side = torch.cuda.Stream()
    outs = []
    for i in range(4):
        with torch.cuda.stream(side if i % 2 else
                               torch.cuda.current_stream()):
            outs.append(k2())
    torch.cuda.synchronize()
    for out in outs:
        assert torch.equal(out, want)


def _small_sponza():
    return procedural.sponza_scene(width=256, height=128, n_textures=8,
                                   target_tris=20_000)


@pytest.mark.gpu
def test_render_loop_presents_the_sequential_frames(cuda_device):
    """RenderLoop with two frames in flight (pinned copies, one event a
    frame) on an orbiting camera presents, byte for byte, the frames that
    ``render()`` + ``.cpu()`` give one at a time with the config each
    loop frame used (the controller may re-tune between frames)."""
    sc = _small_sponza()
    cfg = RenderConfig(width=256, height=128, shadow_extent=512)
    eye0 = np.asarray(sc.camera.eye, np.float32)
    target = np.asarray(sc.camera.look_at, np.float32)
    eyes = []
    for a in np.linspace(0.0, 0.3, 6):
        c, s_ = np.cos(a), np.sin(a)
        d = eye0 - target
        eyes.append(target + np.array([c * d[0] - s_ * d[2], d[1],
                                       s_ * d[0] + c * d[2]], np.float32))
    presented, configs = [], []
    loop = RenderLoop(sc, cfg, on_present=presented.append, target_fps=0.0)
    for eye in eyes:
        sc.camera.set_camera_view(eye, target, np.array([0, 1, 0]))
        loop.render_one()
        configs.append(loop.renderer.config)
        assert len(loop._inflight) <= 2
    loop.drain()
    seq = FrameRenderer(sc, cfg)
    seq._react_overflow = False
    assert len(presented) == len(eyes)
    for eye, c, got in zip(eyes, configs, presented):
        sc.camera.set_camera_view(eye, target, np.array([0, 1, 0]))
        seq.config = c
        want = seq.render()[0].cpu().numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_poll_makes_no_host_sync(cuda_device):
    """On warm frames ``_poll_overflow`` and the queueing of a frame's
    counters run under ``set_sync_debug_mode("error")``: the pinned copies
    and the event never make the host wait, whether the frame is done or
    still in flight."""
    r = FrameRenderer(_small_sponza(), RenderConfig(width=256, height=128,
                                                    shadow_extent=512))
    for _ in range(3):
        r.render()
        torch.cuda.synchronize()
    img, st = r.render()
    queued = len(r._pending_overflow)
    torch.cuda.set_sync_debug_mode("error")
    try:
        r._poll_overflow()                  # the frame may be in flight
        r._queue_stats(st)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        r._poll_overflow()                  # every frame done: all read
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert queued >= 1 and not r._pending_overflow
    assert not any(int(v) for k, v in st.items() if "overflow" in k)


@pytest.mark.gpu
def test_shadow_launch_2048_matches_plain(cuda_device):
    """The apps' default shadow map (2048^2, depth only) through K1 equals
    its plain version bit for bit."""
    r = FrameRenderer(_small_sponza(), RenderConfig(width=256, height=128,
                                                    shadow_extent=2048))
    u = torch.from_numpy(r.uniform_for_camera()).to(cuda_device)
    svp = fr.unpack_params(u, r.n_shadows)["shadow_viewproj"]
    for si in range(r.n_shadows):
        s = fr.shadow_setup(r.scene_dev, svp[si], 2048)
        prep = cr.prepare_pairs(s, 2048, 2048, max_pairs=r._shadow_budget_val)
        assert int(prep.bins.n_overflow) == 0
        b = prep.bins
        args = (prep.pair_data, b.starts, b.counts, 2048 // cr.TILE_W, 2048,
                2048, 0, 0)
        assert torch.equal(cr.raster_tiles(*args),
                           cr._raster_tiles_plain(*args))



def _band_setup(cuda_device, tss):
    """A Sponza view at 640x360 and its band [180, 360) (180 is 4 rows
    into an 8-row tile): the renderer, params and both lists' setups."""
    from renderengine_tpu_torch.graph.uniforms import unpack_params

    cfg = RenderConfig(width=640, height=360, shadows=False)
    if tss:
        cfg = cfg.replace(debug_views=False, texture_space=True,
                          tss_preshaded_blend=True)
    r = FrameRenderer(procedural.sponza_scene(
        width=640, height=360, n_textures=16, target_tris=60_000), cfg,
        device=cuda_device)
    params = unpack_params(torch.from_numpy(r.uniform_for_camera()).to(
        cuda_device), 0)
    return r, params


@pytest.mark.gpu
@pytest.mark.parametrize("launch", ["k1_opaque", "k1_dual_peel", "k2"])
def test_band_launch_matches_plain(cuda_device, launch):
    """K1 (opaque at 8 attributes, the dual peel bounded by the band's
    opaque depth) and K2 (2 blend attributes) launched on a row band that
    starts mid-tile, against their plain versions on the same tables:
    bit-exact, signs of zero included."""
    y0, hs, h, w = 180, 180, 360, 640
    r, params = _band_setup(cuda_device, launch == "k2")
    sd, cfg = r.scene_dev, r.config
    s = restrict_rows(fr.opaque_setup(sd, params, cfg), y0, hs, h)
    pa = fr.opaque_pairs(sd, s, cfg, hs, y0)
    ntx = -(-w // cr.TILE_W)
    ba = pa.bins
    if launch == "k2":
        st = restrict_rows(fr.blend_setup(sd, params, cfg), y0, hs, h)
        pb = fr.blend_pairs(sd, st, cfg, hs, y0)
        args = (pa.pair_data, ba.starts, ba.counts, pb.pair_data,
                pb.bins.starts, pb.bins.counts, ntx, w, h, y0, 2)
        kern = cr.merged_tiles(*args)
        plain = cr._merged_tiles_plain(*args)
    else:
        args = (pa.pair_data, ba.starts, ba.counts, ntx, w, h, y0, 8)
        kw = {}
        if launch == "k1_dual_peel":
            opq = cr.raster_tiles(*args)
            st = restrict_rows(fr.blend_setup(sd, params, cfg), y0, hs, h)
            pb = fr.blend_pairs(sd, st, cfg, hs, y0)
            bounds = torch.stack([torch.full_like(opq[:, 0], -1.0),
                                  opq[:, 0]], 1).contiguous()
            args = (pb.pair_data, pb.bins.starts, pb.bins.counts, ntx, w, h,
                    y0, 8)
            kw = dict(bounds=bounds, dual=True)
        kern = cr.raster_tiles(*args, **kw)
        plain = cr._raster_tiles_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(kern, plain)
    assert torch.equal(torch.signbit(kern), torch.signbit(plain))
    assert (plain[:, 1] >= 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("backend,world", [("nccl", 1), ("gloo", 2)])
def test_sharded_renderer_on_the_card(cuda_device, tmp_path, backend, world):
    """The sharded renderer on the card: a world of 1 over NCCL (the
    backend of one card a rank) and 2 ranks sharing the card over gloo
    (gathers through host memory) give the ``FrameRenderer`` frame and
    shadow blocks, byte for byte, with the same budgets. Each frame
    launches the opaque K1 once, and so does the warm-up of a capture
    (NCCL: the frame program is captured at init; gloo stays eager)."""
    import torch.distributed as dist

    from renderengine_tpu_torch.tools import sharded_run

    if backend == "nccl" and not dist.is_nccl_available():
        pytest.skip("this torch has no NCCL")
    spec = ("sponza_scene", dict(width=320, height=240, n_textures=8,
                                 target_tris=20_000))
    r = FrameRenderer(sharded_run.scene_from_spec(spec),
                      RenderConfig(width=320, height=240, shadow_extent=512,
                                   grid=True), device=cuda_device)
    img, st = r.render()
    assert not any(int(v) for k, v in st.items() if "overflow" in k)
    out = sharded_run.launch(
        {"dist_backend": backend, "world": world,
         "devices": ["cuda:0"] * world, "runs": {"frame": {
             "scene": spec, "config": r.config, "backend": "cuda",
             "shadow_budget": r._shadow_budget_val, "frames": 2,
             "keep_shadow_maps": True}}}, tmp_path, timeout_s=600)
    rec = out["ranks"][0]["runs"]["frame"]
    assert torch.equal(rec["frame"], img.cpu())
    for a, b in zip(rec["shadow_maps"], r._shadow_maps):
        assert torch.equal(a, b.cpu())
    assert out["ranks"][0]["transport"] == (
        "nccl" if backend == "nccl" else "gloo-host")
    for rk in out["ranks"]:
        rec = rk["runs"]["frame"]
        caps = rec["programs"]["frame_captures"]
        assert caps == (1 if backend == "nccl" else 0)
        assert rec["launches"].get("(8, False, False)") == 2 + caps


# --- the captured frame program (graph/program.py) --------------------------

def _graph_cfg(tss: bool):
    cfg = RenderConfig(width=256, height=128, shadow_extent=1024)
    if tss:
        cfg = cfg.replace(debug_views=False, texture_space=True,
                          tss_preshaded_blend=True, dither_trilinear=True,
                          sky_halfres=True)
    return cfg


def _orbit(sc, n):
    """n camera eyes on a short arc around the scene's look-at point."""
    eye0 = np.asarray(sc.camera.eye, np.float32)
    target = np.asarray(sc.camera.look_at, np.float32)
    d = eye0 - target
    out = []
    for a in np.linspace(0.0, 0.25, n):
        c, s_ = np.cos(a), np.sin(a)
        out.append(target + np.array([c * d[0] - s_ * d[2], d[1],
                                      s_ * d[0] + c * d[2]], np.float32))
    return target, out


def _overflow_free(st):
    return not any(int(v) for k, v in st.items() if "overflow" in k)


@pytest.mark.gpu
@pytest.mark.parametrize("tss", [False, True], ids=["per_pixel", "tss"])
def test_warm_render_makes_no_sync(cuda_device, tss, monkeypatch):
    """Once the controller has settled, a warm ``render()`` (the poll, the
    uniform upload, the replay of the captured frame, the queued counters)
    runs under ``set_sync_debug_mode("error")``: no host sync, and no
    frame dispatched op by op."""
    r = FrameRenderer(_small_sponza(), _graph_cfg(tss))
    assert r.program_counts["frame_captures"] == 1
    for _ in range(3):
        r.render()
        torch.cuda.synchronize()
    r.render()
    before = dict(r.program_counts)
    eager = []
    real = fr.render_frame
    monkeypatch.setattr(fr, "render_frame",
                        lambda *a, **k: eager.append(1) or real(*a, **k))
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            img, st = r.render()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert r.program_counts["frame_replays"] == before["frame_replays"] + 3
    assert r.program_counts["frame_captures"] == before["frame_captures"]
    assert not eager
    assert _overflow_free(st)


@pytest.mark.gpu
@pytest.mark.parametrize("tss", [False, True], ids=["per_pixel", "tss"])
def test_replay_equals_the_eager_frame(cuda_device, tss):
    """For three camera poses the replayed frame equals ``render_frame``
    dispatched op by op at the same budgets, byte for byte, with every
    counter 0; the returned frames are the caller's own (a later replay
    leaves them as they were)."""
    sc = _small_sponza()
    r = FrameRenderer(sc, _graph_cfg(tss))
    for _ in range(3):
        r.render()
        torch.cuda.synchronize()
    r._react_overflow = False
    target, eyes = _orbit(sc, 3)
    kept = []
    for eye in eyes:
        sc.camera.set_camera_view(eye, target, np.array([0, 1, 0]))
        img, st = r.render()
        eager, est = r.render_eager()
        assert torch.equal(img, eager)
        assert _overflow_free(st) and _overflow_free(est)
        kept.append((img, img.clone()))
    assert not torch.equal(kept[0][0], kept[-1][0])
    for img, copy in kept:
        assert torch.equal(img, copy)


@pytest.mark.gpu
def test_retune_recaptures(cuda_device):
    """A budget change recaptures the frame program (the controller's
    growth in the poll and a caller's assignment alike), and the
    recaptured frame equals its eager frame."""
    r = FrameRenderer(_small_sponza(), _graph_cfg(False))
    for _ in range(3):
        r.render()
    torch.cuda.synchronize()
    r.render()
    torch.cuda.synchronize()
    caps = r.program_counts["frame_captures"]
    budget = r.config.raster.pair_budget
    zero = torch.zeros((), dtype=torch.int64)
    r._pending_overflow.clear()
    r._queue_stats({"pair_overflow": zero + 5000,
                    "pair_tail_overflow": zero,
                    "blend_pair_overflow": zero})
    img, _ = r.render()              # the poll grows the pair budget
    assert r.config.raster.pair_budget > budget
    assert r.program_counts["frame_captures"] == caps + 1
    assert r._programs.progs["frame"].key == r.config
    assert torch.equal(img, r.render_eager()[0])
    r.config = r.config.replace(penumbra_tile_budget=64)
    assert r.program_counts["frame_captures"] == caps + 2
    r._react_overflow = False
    img, _ = r.render()
    assert torch.equal(img, r.render_eager()[0])


@pytest.mark.gpu
@pytest.mark.parametrize("tss", [False, True], ids=["per_pixel", "tss"])
def test_dirty_shadow_frame_equals_eager(cuda_device, tss):
    """``mark_shadows_dirty()``: the next frame replays the shadow program,
    whose maps land in the pack the frame program reads (and, with TSS,
    the bakes in the tables it reads), and equals its eager frame."""
    r = FrameRenderer(_small_sponza(), _graph_cfg(tss))
    for _ in range(3):
        r.render()
    torch.cuda.synchronize()
    r._react_overflow = False
    ptrs = tuple(t.data_ptr() for t in r._shadow_maps)
    shadows = r.program_counts["shadow_replays"]
    r.mark_shadows_dirty()
    img, st = r.render()
    assert r.program_counts["shadow_replays"] == shadows + 1
    assert tuple(t.data_ptr() for t in r._shadow_maps) == ptrs
    assert torch.equal(img, r.render_eager()[0])
    assert _overflow_free(st) and r.shadow_overflow == 0


# --- the texture-space bake programs and the sharded programs ---------------

def _delta(before, after):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _eager_bakes_frame(r, visibility):
    """The TSS bakes and the frame, dispatched op by op over the
    renderer's current state (uniform, shadow pack)."""
    for _, _, fn in r.tss_bakes(visibility):
        fn()
    return r.render_eager()[0]


@pytest.mark.gpu
def test_tss_exposure_frame_replays_without_sync(cuda_device):
    """An exposure change on a warm TSS renderer replays the table program
    (captured at init beside the visibility program) and the frame, under
    ``set_sync_debug_mode("error")``; the frame equals the eager bakes'
    and eager frame's, byte for byte."""
    from renderengine_tpu_torch.scene.camera import ViewProperties

    sc = _small_sponza()
    r = FrameRenderer(sc, _graph_cfg(True))
    st = r.program_stats()
    assert (st["mode"], st["vis_captures"], st["tables_captures"]) == \
        ("captured", 1, 1)
    for _ in range(3):
        r.render()
        torch.cuda.synchronize()
    base, _ = r.render()
    before = dict(r.program_counts)
    vp = ViewProperties.from_camera(sc.camera)
    vp.exposure = float(sc.camera.exposure) * 1.5
    torch.cuda.set_sync_debug_mode("error")
    try:
        img, st = r.render(vp)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert _delta(before, r.program_counts) == {"tables_replays": 1,
                                                "frame_replays": 1}
    assert _overflow_free(st) and not torch.equal(img, base)
    assert torch.equal(img, _eager_bakes_frame(r, visibility=False))


@pytest.mark.gpu
def test_tss_dirty_frame_syncs_only_on_the_overflow_read(cuda_device):
    """A shadow-dirty TSS frame replays the shadow, visibility, table and
    frame programs, and its one synchronizing call is the shadow pass's
    overflow read (``FrameRenderer._render_shadows``); the frame equals
    the eager bakes' and eager frame's, byte for byte."""
    import inspect

    from renderengine_tpu_torch.tools.sync_sites import sync_sites

    r = FrameRenderer(_small_sponza(), _graph_cfg(True))
    for _ in range(3):
        r.render()
        torch.cuda.synchronize()
    r._react_overflow = False
    before = dict(r.program_counts)
    r.mark_shadows_dirty()
    out = []
    sites = sync_sites(lambda: out.append(r.render()))
    lines, first = inspect.getsourcelines(fr.FrameRenderer._render_shadows)
    line = first + next(i for i, t in enumerate(lines) if "int(sov)" in t)
    assert sites["calls"] == 1, sites
    (site,) = sites["sites"]
    assert site.startswith(f"/graph/frame.py:{line}"), (site, line)
    assert _delta(before, r.program_counts) == {
        "shadow_replays": 1, "vis_replays": 1, "tables_replays": 1,
        "frame_replays": 1}
    img, st = out[0]
    assert _overflow_free(st) and r.shadow_overflow == 0
    assert torch.equal(img, _eager_bakes_frame(r, visibility=True))


@pytest.mark.gpu
@pytest.mark.parametrize("tss", [False, True], ids=["per_pixel", "tss"])
def test_sharded_nccl_replays_its_programs(cuda_device, tmp_path, tss):
    """A world of 1 over NCCL captures the band frame, the sharded shadow
    pass and (TSS) the bakes at init; warm frames run under
    ``set_sync_debug_mode("error")`` and make no synchronizing call, an
    exposure frame none, a dirty frame one (the overflow read); the base,
    exposure and dirty frames and the shadow blocks equal the
    ``FrameRenderer``'s byte for byte."""
    import torch.distributed as dist

    from renderengine_tpu_torch.scene.camera import ViewProperties
    from renderengine_tpu_torch.tools import sharded_run

    if not dist.is_nccl_available():
        pytest.skip("this torch has no NCCL")
    spec = ("sponza_scene", dict(width=320, height=240, n_textures=8,
                                 target_tris=20_000))
    cfg = RenderConfig(width=320, height=240, shadow_extent=512)
    if tss:
        cfg = cfg.replace(debug_views=False, texture_space=True,
                          tss_preshaded_blend=True, dither_trilinear=True,
                          sky_halfres=True)
    sc = sharded_run.scene_from_spec(spec)
    r = FrameRenderer(sc, cfg, device=cuda_device)
    img, st = r.render()
    assert _overflow_free(st)
    r._react_overflow = False
    vp = ViewProperties.from_camera(sc.camera)
    vp.exposure = float(sc.camera.exposure) * 1.5
    bright = r.render(vp)[0].cpu()
    r.mark_shadows_dirty()
    dirty = r.render()[0].cpu()
    out = sharded_run.launch(
        {"dist_backend": "nccl", "world": 1, "devices": ["cuda:0"],
         "runs": {"frame": {
             "scene": spec, "config": r.config, "backend": "cuda",
             "shadow_budget": r._shadow_budget_val, "frames": 3,
             "sync_error": True, "exposure_scale": 1.5, "dirty_frame": True,
             "keep_shadow_maps": True}}}, tmp_path, timeout_s=600)
    rk = out["ranks"][0]
    rec = rk["runs"]["frame"]
    assert rk["transport"] == "nccl"
    pst = rec["programs"]
    names = ["frame", "shadow"] + (["vis", "tables"] if tss else [])
    assert pst["mode"] == "captured"
    assert {n: pst[f"{n}_captures"] for n in names} == dict.fromkeys(names,
                                                                      1)
    assert pst["frame_replays"] == 3 + 1 + 2
    assert rec["sync"]["calls"] == 0 and rec["sync_exposure"]["calls"] == 0
    assert rec["sync_dirty"]["calls"] == 1, rec["sync_dirty"]
    assert torch.equal(rec["frame"], img.cpu())
    assert torch.equal(rec["frame_exposure"], bright)
    assert torch.equal(rec["frame_dirty"], dirty)
    for a, b in zip(rec["shadow_maps"], r._shadow_maps):
        assert torch.equal(a, b.cpu())
    assert rec["shadow_overflow_dirty"] == 0


@pytest.mark.gpu
def test_failed_capture_raises(cuda_device):
    """A function that reads device data on the host cannot be captured:
    the capture raises, and the launch counters are as before."""
    from renderengine_tpu_torch.graph.program import CapturedProgram

    x = torch.ones(4, device=cuda_device)
    before = cr.count_snapshot()
    with pytest.raises(RuntimeError):
        CapturedProgram(lambda: x * float(x.sum()), cuda_device,
                        torch.cuda.Stream())
    assert cr.count_snapshot() == before


@pytest.mark.gpu
def test_captured_launch_outlives_a_workspace_growth(cuda_device):
    """A K1 launch captured by ``CapturedProgram`` on the index-less
    ``cuda`` device keeps its workspace: after a larger launch grows the
    device's workspace and the freed memory goes back to the driver, the
    replay still equals the plain version."""
    from renderengine_tpu_torch.graph.program import CapturedProgram

    rng = np.random.default_rng(31)
    s = _random_setup(rng, 60, 97, 61, CullMode.NONE)
    prep = cr.prepare_pairs(s.__class__(*(t.to(cuda_device) for t in s)),
                            61, 97, max_pairs=8192)
    b = prep.bins
    args = (prep.pair_data, b.starts, b.counts, -(-97 // cr.TILE_W), 97, 61)
    want = cr._raster_tiles_plain(*args)
    torch.cuda.synchronize()
    prog = CapturedProgram(lambda: cr.raster_tiles(*args), "cuda",
                           torch.cuda.Stream())
    assert len(prog.workspace) == 2
    big = _random_setup(rng, 400, 1024, 768, CullMode.NONE)
    pb = cr.prepare_pairs(big.__class__(*(t.to(cuda_device) for t in big)),
                          768, 1024, max_pairs=1 << 18)
    cr.raster_tiles(pb.pair_data, pb.bins.starts, pb.bins.counts,
                    1024 // cr.TILE_W, 1024, 768)
    assert cr.workspace_tensors("cuda")[0].data_ptr() != \
        prog.workspace[0].data_ptr()
    del pb
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = prog.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


# --- the tiered anisotropic sampler (csrc/aniso_slots.cu) -------------------

def _aniso_exact(args, spec, caps, seg_w=128):
    """The kernel's slots against the plain version's, bit for bit (the
    int32 views: NaNs and signed zeros too); returns the kernel's."""
    got = sampling.aniso_slots(*args, spec, slot_caps=caps, seg_w=seg_w)
    want = sampling.sample_slots_aniso_tiered_plain(*args, spec,
                                                    slot_caps=caps,
                                                    seg_w=seg_w)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
            float((a - b).abs().max())
    return got


# (H, W, words, slots used, spec, seg_w): the 1080p frame's shape, a peel
# pseudo-image one segment wide (every tier runs on every pixel), the
# 3840x2160 ``ssaa=2`` plane, u16 beside u8, a slot no material uses, a
# ladder with every segment selected and one with 32-wide segments
ANISO_CASES = {
    "frame_u8": (1080, 1920, 4, (0, 1, 2, 3), ai.DEFAULT_SPEC, 128),
    "frame_u16": (1080, 1920, 8, (0, 1, 2, 3), ai.DEFAULT_SPEC, 128),
    "peel_u8": (1080, 128, 4, (0, 1, 2, 3), ai.DEFAULT_SPEC, 128),
    "peel_u16": (520, 128, 8, (0, 1, 2, 3), ai.DEFAULT_SPEC, 128),
    "ssaa2_u8": (2160, 3840, 4, (0, 1, 2, 3), ai.DEFAULT_SPEC, 128),
    "three_slots": (270, 480, 4, (0, 2, 3), ai.DEFAULT_SPEC, 128),
    "all_selected": (136, 512, 8, (0, 1, 2, 3),
                     sampling.AnisoSpec(16, (1.0, 1.0, 1.0)), 128),
    "seg32": (64, 333, 4, (0, 1, 3),
              sampling.AnisoSpec(8, (0.5, 0.25), (8, 1, 2, 4)), 32),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(ANISO_CASES))
def test_aniso_kernel_matches_plain(cuda_device, case):
    h, w, words, used, spec, seg_w = ANISO_CASES[case]
    args = ai.to(ai.case(40 + len(case), h, w, words=words, used=used),
                 cuda_device)
    caps = None if not spec.slot_caps else [spec.slot_caps[s] for s in used]
    before = cr.launch_counts["aniso_slots"]
    _aniso_exact(args, spec, caps, seg_w)
    assert cr.launch_counts["aniso_slots"] == before + 1


@pytest.mark.gpu
def test_aniso_kernel_makes_no_host_sync(cuda_device):
    """The wrapper selects the segments and launches from shapes alone,
    and a row band of the planes gives the whole plane's rows (the
    selection is per row)."""
    args = ai.to(ai.case(7, 96, 640), cuda_device)
    full = sampling.aniso_slots(*args, ai.DEFAULT_SPEC)     # loads
    torch.cuda.synchronize()
    atlas, mip_y, mip_x, sl, uv, dx, dy = args
    band = [({k: v[40:].contiguous() for k, v in tex.items()},
             nm[40:].contiguous()) for tex, nm in sl]
    torch.cuda.set_sync_debug_mode("error")
    try:
        rows = sampling.aniso_slots(atlas, mip_y, mip_x, band,
                                    uv[40:].contiguous(),
                                    dx[40:].contiguous(),
                                    dy[40:].contiguous(), ai.DEFAULT_SPEC)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for a, b in zip(rows, full):
        assert torch.equal(a, b[40:])


@pytest.mark.gpu
def test_aniso_kernel_refuses_bad_inputs(cuda_device):
    atlas, mip_y, mip_x, sl, uv, dx, dy = ai.to(ai.case(8, 16, 64),
                                                cuda_device)
    with pytest.raises(ValueError, match="one device"):
        sampling.aniso_slots(atlas, mip_y, mip_x, sl, uv.cpu(), dx, dy,
                             ai.DEFAULT_SPEC)
    odd = uv.view(-1)[1:1 + 16 * 63 * 2].view(16, 63, 2)    # 4-byte offset
    sl63 = [({k: v[:, 1:].contiguous() for k, v in tex.items()},
             nm[:, 1:].contiguous()) for tex, nm in sl]
    with pytest.raises(ValueError, match="uv planes on 8"):
        sampling.aniso_slots(atlas, mip_y, mip_x, sl63, odd,
                             dx[:, 1:].contiguous(), dy[:, 1:].contiguous(),
                             ai.DEFAULT_SPEC)


def _sponza1080():
    """The benchmark's per-pixel scene and configuration at 1080p."""
    return procedural.sponza_scene(width=1920, height=1080, n_textures=200,
                                   target_tris=260_000)


def _orbit_pose(sc, i):
    """Pose ``i`` of the benchmark's orbit: the scene's eye turned 0.02 *
    i rad about the world's +y axis."""
    e = np.asarray(sc.camera.eye, np.float32)
    a = 0.02 * i
    sc.camera.set_camera_view(
        np.array([e[0] * np.cos(a) - e[2] * np.sin(a), e[1],
                  e[0] * np.sin(a) + e[2] * np.cos(a)], np.float32),
        sc.camera.look_at, np.array([0, 1, 0], np.float32))


def _sampler_calls(monkeypatch, render):
    """The tiered sampler's arguments in each call of ``render()``
    (contiguous copies), in call order."""
    calls = []
    real = sampling.sample_slots_aniso_tiered

    def record(atlas, mip_y, mip_x, slots, uv, duv_dx, duv_dy, spec,
               slot_caps=None, seg_w=128):
        calls.append(((atlas, mip_y, mip_x,
                       [({k: tex[k].clone() for k in ai.PLANES}, nm.clone())
                        for tex, nm in slots],
                       uv.contiguous().clone(), duv_dx.clone(),
                       duv_dy.clone()), spec, slot_caps, seg_w))
        return real(atlas, mip_y, mip_x, slots, uv, duv_dx, duv_dy, spec,
                    slot_caps, seg_w)

    with monkeypatch.context() as m:
        m.setattr(sampling, "sample_slots_aniso_tiered", record)
        render()
    return calls


@pytest.mark.gpu
def test_aniso_kernel_on_the_sponza_frame(cuda_device, monkeypatch):
    """The 1080p Sponza default per-pixel frame at pose 300 of the
    benchmark's orbit: the sampler's three calls (the opaque layer's full
    frame and the two peel layers' 128-wide pseudo-images, where every
    tier runs on every pixel) and a row band of the opaque call, kernel
    against plain bit for bit; every replay of the captured frame counts
    three launches; and the whole eager frame through the kernel equals,
    byte for byte, the eager frame with the plain sampler."""
    sc = _sponza1080()
    r = FrameRenderer(sc, RenderConfig(width=1920, height=1080,
                                       shadow_extent=4096))
    _orbit_pose(sc, 300)
    r._react_overflow = False
    # peel budgets under the 2025 shade tiles: both layers go through
    # shade_sparse, as in the benchmark's settled window
    r.config = r.config.replace(blend_layer_tile_budgets=(600, 300))
    for _ in range(2):
        r.render()
        torch.cuda.synchronize()
    before = cr.launch_counts["aniso_slots"]
    for _ in range(2):
        r.render()
    torch.cuda.synchronize()
    assert cr.launch_counts["aniso_slots"] == before + 6

    calls = _sampler_calls(monkeypatch, r.render_eager)
    assert len(calls) == 3
    assert calls[0][0][4].shape[:2] == (1080, 1920)
    assert all(c[0][4].shape[1] == 128 for c in calls[1:])
    for args, spec, caps, seg_w in calls:
        _aniso_exact(args, spec, caps, seg_w)
    (atlas, mip_y, mip_x, sl, uv, dx, dy), spec, caps, seg_w = calls[0]
    band = (atlas, mip_y, mip_x,
            [({k: v[536:].contiguous() for k, v in tex.items()},
              nm[536:].contiguous()) for tex, nm in sl],
            uv[536:].contiguous(), dx[536:].contiguous(),
            dy[536:].contiguous())
    _aniso_exact(band, spec, caps, seg_w)

    img = r.render_eager()[0]
    with monkeypatch.context() as m:
        m.setattr(sampling, "sample_slots_aniso_tiered",
                  sampling.sample_slots_aniso_tiered_plain)
        plain = r.render_eager()[0]
    assert torch.equal(img, plain)


@pytest.mark.gpu
def test_aniso_kernel_on_the_ssaa2_frame(cuda_device, monkeypatch):
    """The ``ssaa=2`` per-pixel frame's opaque sampler call (3840x2160),
    kernel against plain bit for bit."""
    sc = _sponza1080()
    r = FrameRenderer(sc, RenderConfig(width=1920, height=1080,
                                       shadow_extent=4096, ssaa=2))
    _orbit_pose(sc, 300)
    r.render()
    torch.cuda.synchronize()
    calls = _sampler_calls(monkeypatch, r.render_eager)
    assert calls[0][0][4].shape[:2] == (2160, 3840)
    args, spec, caps, seg_w = calls[0]
    _aniso_exact(args, spec, caps, seg_w)


@pytest.mark.gpu
@pytest.mark.parametrize("tss", [False, True], ids=["per_pixel", "tss"])
def test_replays_count_the_aniso_launches(cuda_device, tss):
    """A replay of the captured frame adds the launches its eager frame
    makes: three tiered sampler calls in the per-pixel frame (the opaque
    layer and two peel layers), none in the texture-space frame."""
    r = FrameRenderer(_small_sponza(), _graph_cfg(tss))
    for _ in range(3):
        r.render()
        torch.cuda.synchronize()
    r._react_overflow = False
    before = cr.launch_counts["aniso_slots"]
    r.render_eager()
    eager = cr.launch_counts["aniso_slots"] - before
    assert eager == (0 if tss else 3)
    before = cr.launch_counts["aniso_slots"]
    for _ in range(3):
        r.render()
    torch.cuda.synchronize()
    assert cr.launch_counts["aniso_slots"] - before == 3 * eager


# --- the texture-space peel pass (csrc/tss_peel.cu) -------------------------

def _peel_inputs(dev, h, w, ah=1536, aw=1024, seed=0):
    """Random inputs of the peel pass on ``dev``: any int32 is an rgb9e5
    word and an alpha block, chart uvs run past the atlas on both sides,
    about 3/5 of each layer's pixels are covered, and the factor alphas
    of ``mat_all`` run past [0, 1]. (rgb, rgb_blocks, a_blocks, layers,
    ah, aw, mat_all)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=g,
                             device=dev, dtype=torch.int64).to(torch.int32)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    layers = [(torch.where(rand(h, w) < 0.6, 7, -1).to(torch.int32),
               rand(h, w, 2) * torch.tensor([aw + 8.0, ah + 8.0],
                                            device=dev) - 4.0,
               torch.randint(0, 40, (h, w), generator=g, device=dev,
                             dtype=torch.int32))
              for _ in range(2)]
    mat = (rand(40, 24) * 1.4 - 0.2).to(torch.float16)
    return (rand(h, w, 3) * 8.0, words(ah * aw, 4), words(ah * aw), layers,
            ah, aw, mat)


def _peel_exact(rgb, rb, ab, layers, ah, aw, mat=None):
    """The kernel against the plain version on copies of ``rgb``, bit for
    bit (the int32 views: NaNs and signed zeros too); returns the
    kernel's."""
    got = _peel_kernel(rgb.clone(), rb, ab, layers, ah, aw, mat)
    want = lc.tss_peel_composite_plain(rgb.clone(), rb, ab, layers, ah, aw,
                                       mat)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
        float((got - want).abs().max())
    return got


def _peel_kernel(*a):
    """One wrapper call on the card: one launch counted."""
    before = cr.launch_counts["tss_peel"]
    out = lc.tss_peel_composite(*a)
    assert cr.launch_counts["tss_peel"] == before + 1
    return out


# (H, W, alpha source): the 1080p frame, the ``ssaa=2`` 3840x2160 plane,
# an odd small plane
PEEL_CASES = {"frame_blocks": (1080, 1920, "blocks"),
              "frame_factor": (1080, 1920, "factor"),
              "ssaa2_blocks": (2160, 3840, "blocks"),
              "ssaa2_factor": (2160, 3840, "factor"),
              "odd_blocks": (37, 53, "blocks")}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(PEEL_CASES))
def test_tss_peel_kernel_matches_plain(cuda_device, case):
    """Eager launches: the whole plane and a row band of it (rows 536 on,
    contiguous copies), which equals the plane's rows."""
    h, w, alpha = PEEL_CASES[case]
    rgb, rb, ab, layers, ah, aw, mat = _peel_inputs(cuda_device, h, w)
    mat = mat if alpha == "factor" else None
    got = _peel_exact(rgb, rb, ab, layers, ah, aw, mat)
    y0 = min(536, h // 2)
    band = [tuple(t[y0:].contiguous() for t in layer) for layer in layers]
    got_b = _peel_exact(rgb[y0:].contiguous(), rb, ab, band, ah, aw, mat)
    assert torch.equal(got_b, got[y0:])
    # covered pixels moved, pixels no layer covers kept their colour
    none = (layers[0][0] < 0) & (layers[1][0] < 0)
    assert torch.equal(got[none], rgb[none])
    assert not torch.equal(got[~none], rgb[~none])


@pytest.mark.gpu
@pytest.mark.parametrize("alpha", ["blocks", "factor"])
def test_tss_peel_kernel_replayed_in_a_graph(cuda_device, alpha):
    """The launch captured in a CUDA graph and replayed over new colour
    planes copied into its input: each replay equals the plain version."""
    rgb, rb, ab, layers, ah, aw, mat = _peel_inputs(cuda_device, 1080, 1920)
    mat = mat if alpha == "factor" else None
    buf = rgb.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        lc.tss_peel_composite(buf, rb, ab, layers, ah, aw, mat)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            lc.tss_peel_composite(buf, rb, ab, layers, ah, aw, mat)
    torch.cuda.current_stream().wait_stream(side)
    for seed in (1, 2):
        src = _peel_inputs(cuda_device, 1080, 1920, seed=seed)[0]
        buf.copy_(src)
        graph.replay()
        want = lc.tss_peel_composite_plain(src.clone(), rb, ab, layers, ah,
                                           aw, mat)
        torch.cuda.synchronize()
        assert torch.equal(buf.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_tss_peel_kernel_makes_no_host_sync(cuda_device):
    rgb, rb, ab, layers, ah, aw, mat = _peel_inputs(cuda_device, 64, 96)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lc.tss_peel_composite(rgb, rb, ab, layers, ah, aw)
        lc.tss_peel_composite(rgb, rb, ab, layers, ah, aw, mat)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_tss_peel_kernel_refuses_bad_inputs(cuda_device):
    rgb, rb, ab, layers, ah, aw, mat = _peel_inputs(cuda_device, 16, 32,
                                                    ah=8, aw=8)
    with pytest.raises(ValueError, match="device"):
        lc.tss_peel_composite(rgb, rb, ab.cpu(), layers, ah, aw)
    with pytest.raises(ValueError, match="device"):
        lc.tss_peel_composite(rgb, rb, ab, [layers[0], tuple(
            t.cpu() for t in layers[1])], ah, aw)
    shifted = torch.zeros(ah * aw * 4 + 1, dtype=torch.int32,
                          device=cuda_device)[1:].view(ah * aw, 4)
    with pytest.raises(ValueError, match="16 bytes"):
        lc.tss_peel_composite(rgb, shifted, ab, layers, ah, aw)
    with pytest.raises(ValueError, match="float16"):
        lc.tss_peel_composite(rgb, rb, ab, layers, ah, aw, mat.float())


def _tss_sponza_renderer(ssaa=1):
    """The benchmark's texture-space headline (``sponza1080_tss``) at orbit
    pose 300, its controller frozen after two frames."""
    sc = _sponza1080()
    r = FrameRenderer(sc, RenderConfig(
        width=1920, height=1080, shadow_extent=4096, debug_views=False,
        texture_space=True, tss_preshaded_blend=True, dither_trilinear=True,
        sky_halfres=True, ssaa=ssaa))
    _orbit_pose(sc, 300)
    for _ in range(2):
        r.render()
        torch.cuda.synchronize()
    r._react_overflow = False
    return r


def _peel_calls(monkeypatch, render):
    """The peel pass's arguments in each call of ``render()`` (the colour
    plane copied as it entered)."""
    calls = []
    real = lc.tss_peel_composite

    def record(rgb, rgb_blocks, a_blocks, layers, ah, aw, mat_all=None):
        calls.append((rgb.clone(), rgb_blocks, a_blocks,
                      [tuple(t.clone() for t in layer) for layer in layers],
                      ah, aw, mat_all))
        return real(rgb, rgb_blocks, a_blocks, layers, ah, aw, mat_all)

    with monkeypatch.context() as m:
        m.setattr(lc, "tss_peel_composite", record)
        render()
    return calls


@pytest.mark.gpu
def test_tss_peel_on_the_sponza_frame(cuda_device, monkeypatch):
    """The 1080p Sponza texture-space headline at pose 300 of the
    benchmark's orbit: one peel launch a frame, eager and in every replay
    of the captured frame; its call, and a row band of it, kernel against
    plain bit for bit; the whole eager frame equals the eager frame with
    the plain version monkeypatched in; the frame reports no observed
    shade tiles and drops nothing."""
    r = _tss_sponza_renderer()
    before = cr.launch_counts["tss_peel"]
    for _ in range(3):
        img, st = r.render()
    torch.cuda.synchronize()
    assert cr.launch_counts["tss_peel"] == before + 3
    assert "blend_shade_tiles" not in st
    assert _overflow_free(st)
    calls = _peel_calls(monkeypatch, r.render_eager)
    assert len(calls) == 1
    rgb, rb, ab, layers, ah, aw, mat = calls[0]
    assert rgb.shape[:2] == (1080, 1920)
    assert all(int((layer[0] >= 0).sum()) > 0 for layer in layers)
    _peel_exact(rgb, rb, ab, layers, ah, aw, mat)
    band = [tuple(t[536:].contiguous() for t in layer) for layer in layers]
    _peel_exact(rgb[536:].contiguous(), rb, ab, band, ah, aw, mat)
    eager = r.render_eager()[0]
    assert torch.equal(eager, img)
    with monkeypatch.context() as m:
        m.setattr(lc, "tss_peel_composite", lc.tss_peel_composite_plain)
        plain = r.render_eager()[0]
    assert torch.equal(eager, plain)


@pytest.mark.gpu
def test_tss_peel_on_the_ssaa2_frame(cuda_device, monkeypatch):
    """The ``ssaa=2`` headline's peel call (3840x2160), kernel against
    plain bit for bit."""
    r = _tss_sponza_renderer(ssaa=2)
    calls = _peel_calls(monkeypatch, r.render_eager)
    assert len(calls) == 1 and calls[0][0].shape[:2] == (2160, 3840)
    _peel_exact(*calls[0])


@pytest.mark.gpu
@pytest.mark.parametrize("tss", [False, True], ids=["per_pixel", "tss"])
def test_replays_count_the_tss_peel_launches(cuda_device, tss):
    """A replay of the captured frame adds the launches its eager frame
    makes: one peel launch in the texture-space frame, none in the
    per-pixel frame."""
    r = FrameRenderer(_small_sponza(), _graph_cfg(tss))
    for _ in range(3):
        r.render()
        torch.cuda.synchronize()
    r._react_overflow = False
    before = cr.launch_counts["tss_peel"]
    r.render_eager()
    eager = cr.launch_counts["tss_peel"] - before
    assert eager == (1 if tss else 0)
    before = cr.launch_counts["tss_peel"]
    for _ in range(3):
        r.render()
    torch.cuda.synchronize()
    assert cr.launch_counts["tss_peel"] - before == 3 * eager


@pytest.mark.gpu
def test_tss_orbit_drops_no_peel_work(cuda_device):
    """A small texture-space scene over two cycles of the benchmark's orbit
    (314 poses each) with the controller on: after the first cycle, no
    frame of the second reports observed peel shade tiles or any dropped
    work, and the frame program is never captured again."""
    sc = _small_sponza()
    r = FrameRenderer(sc, _graph_cfg(True))
    e0 = np.asarray(sc.camera.eye, np.float32)
    target = np.asarray(sc.camera.look_at, np.float32)

    def pose(i):
        a = 0.02 * i
        sc.camera.set_camera_view(
            np.array([e0[0] * np.cos(a) - e0[2] * np.sin(a), e0[1],
                      e0[0] * np.sin(a) + e0[2] * np.cos(a)], np.float32),
            target, np.array([0, 1, 0], np.float32))

    for i in range(314):
        pose(i)
        r.render()
    torch.cuda.synchronize()
    r._poll_overflow()
    caps = r.program_counts["frame_captures"]
    stats = []
    for i in range(314, 628):
        pose(i)
        stats.append(r.render()[1])
    torch.cuda.synchronize()
    assert not any("blend_shade_tiles" in st for st in stats)
    assert all(_overflow_free(st) for st in stats)
    assert r.program_counts["frame_captures"] == caps
    assert r.config.blend_layer_tile_budgets == ()


# --- the factored texture-space screen pass (csrc/tss_shade.cu) -------------

def _shade_kernel(*args, **kw):
    """One wrapper call on the card: one launch counted."""
    before = cr.launch_counts["tss_shade"]
    out = lc.tss_shade_halfres(*args, **kw)
    assert cr.launch_counts["tss_shade"] == before + 1
    return out


def _shade_exact(args, **kw):
    """The kernel against the plain version, bit for bit (the int32
    views: NaNs and signed zeros too); returns the kernel's."""
    got = _shade_kernel(*args, **kw)
    want = lc.tss_shade_halfres_plain(*args, **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
        float((got - want).abs().max())
    return got


def _shade_case(dev, seed, h, w, words=4):
    """``aniso_inputs.tss_shade_case`` on ``dev``, chart uv and uv views
    of one [H, W, 4] plane."""
    sc, cu, uv, mat, l8, ah, aw, cov = ai.tss_shade_case(seed, h, w, words)
    attrs = torch.cat([cu, uv], -1).to(dev)
    return ({k: v.to(dev) for k, v in sc.items()}, attrs[..., 0:2],
            attrs[..., 2:4], mat.to(dev), l8.to(dev), ah, aw, cov.to(dev))


# a call's settings (y0, dither, max_taps, slot 0 used): the headline's
# first, then exact taps, trilinear, no base texture, a band starting on
# an odd row
SHADE_SETTINGS = {"dither_aniso16": (0, True, 16, True),
                  "exact_aniso16": (0, False, 16, True),
                  "dither_trilinear": (0, True, 1, True),
                  "exact_trilinear": (0, False, 1, True),
                  "no_base_slot": (0, True, 16, False),
                  "band_y0_odd": (537, True, 16, True),
                  "band_y0_odd_exact": (537, False, 1, True)}


def _shade_settings(name):
    y0, dither, taps, slot0 = SHADE_SETTINGS[name]
    return dict(y0=y0, dither=dither,
                max_aniso=sampling.AnisoSpec(taps, (0.25, 0.15, 0.08),
                                             (16, 4, 4, 4)),
                slots_used=(slot0, True, True, True))


def _shade_band(args, name):
    """A call's arguments and settings; for a band setting, the rows
    [y0, y0 + 542) of the planes as views (the band's half grid starts on
    the odd global row y0)."""
    kw = _shade_settings(name)
    y0 = kw["y0"]
    if not y0:
        return args, kw
    sc, cu, uv, mat, l8, ah, aw, cov = args
    rows = slice(y0, y0 + 542)
    return (sc, cu[rows], uv[rows], mat[rows], l8, ah, aw,
            None if cov is None else cov[rows]), kw


@pytest.mark.gpu
@pytest.mark.parametrize("setting", list(SHADE_SETTINGS))
def test_tss_shade_kernel_matches_plain(cuda_device, setting):
    """Synthetic 1080p planes (u8 atlas) at every setting."""
    args = _shade_case(cuda_device, 5, 1080, 1920)
    band, kw = _shade_band(args, setting)
    _shade_exact(band[:7], covered=band[7], **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["u16_odd", "no_coverage", "ssaa2"])
def test_tss_shade_kernel_other_shapes(cuda_device, case):
    """A u16 atlas on an odd-width plane of 38 rows starting on an odd
    row, raw quad derivatives (no coverage), and the 3840x2160 ``ssaa=2``
    plane at the headline's settings."""
    kw = _shade_settings("dither_aniso16")
    if case == "u16_odd":
        args = _shade_case(cuda_device, 6, 38, 53, words=8)
        for name in ("dither_aniso16", "exact_aniso16", "exact_trilinear"):
            _shade_exact(args[:7], covered=args[7],
                         **dict(_shade_settings(name), y0=5))
    elif case == "no_coverage":
        args = _shade_case(cuda_device, 7, 270, 480)
        _shade_exact(args[:7], covered=None, **kw)
        _shade_exact(args[:7], covered=None,
                     **_shade_settings("exact_aniso16"))
    else:
        args = _shade_case(cuda_device, 8, 2160, 3840)
        _shade_exact(args[:7], covered=args[7], **kw)


@pytest.mark.gpu
def test_tss_shade_kernel_replayed_in_a_graph(cuda_device):
    """The launch captured in a CUDA graph and replayed over new planes
    copied into its inputs: each replay equals the plain version."""
    sc, cu, uv, mat, l8, ah, aw, cov = _shade_case(cuda_device, 9, 1080, 1920)
    attrs = cu._base
    kw = _shade_settings("dither_aniso16")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        lc.tss_shade_halfres(sc, cu, uv, mat, l8, ah, aw, covered=cov, **kw)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = lc.tss_shade_halfres(sc, cu, uv, mat, l8, ah, aw,
                                       covered=cov, **kw)
    torch.cuda.current_stream().wait_stream(side)
    for seed in (10, 11):
        _, cu2, uv2, mat2, l82, _, _, cov2 = _shade_case(cuda_device, seed,
                                                         1080, 1920)
        attrs.copy_(cu2._base)
        for dst, src in ((mat, mat2), (l8, l82), (cov, cov2)):
            dst.copy_(src)
        graph.replay()
        want = lc.tss_shade_halfres_plain(sc, cu, uv, mat, l8, ah, aw,
                                          covered=cov, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_tss_shade_kernel_makes_no_host_sync(cuda_device):
    args = _shade_case(cuda_device, 12, 64, 96)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for name in ("dither_aniso16", "exact_trilinear"):
            lc.tss_shade_halfres(*args[:7], covered=args[7],
                                 **_shade_settings(name))
        lc.tss_shade_halfres(*args[:7], covered=None)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_tss_shade_kernel_refuses_bad_inputs(cuda_device):
    sc, cu, uv, mat, l8, ah, aw, cov = _shade_case(cuda_device, 13, 16, 32)
    with pytest.raises(ValueError, match="device"):
        lc.tss_shade_halfres(sc, cu, uv, mat, l8.cpu(), ah, aw, covered=cov)
    with pytest.raises(ValueError, match="device"):
        lc.tss_shade_halfres(sc, cu, uv, mat.cpu(), l8, ah, aw, covered=cov)
    shifted = torch.zeros(ah * aw * 8 + 1, dtype=torch.int32,
                          device=cuda_device)[1:].view(ah * aw, 8)
    with pytest.raises(ValueError, match="16 bytes"):
        lc.tss_shade_halfres(sc, cu, uv, mat, shifted, ah, aw, covered=cov)
    with pytest.raises(ValueError, match="float16"):
        lc.tss_shade_halfres(dict(sc, mat_all=sc["mat_all"].float()), cu, uv,
                             mat, l8, ah, aw, covered=cov)
    with pytest.raises(ValueError, match="even height"):
        lc.tss_shade_halfres(sc, cu[1:], uv[1:], mat[1:], l8, ah, aw, y0=1,
                             covered=cov[1:])
    with pytest.raises(ValueError, match="contiguous"):
        lc.tss_shade_halfres(dict(sc, atlas=sc["atlas"][:, ::2]), cu, uv,
                             mat, l8, ah, aw, covered=cov)


def _shade_calls(monkeypatch, render):
    """The screen pass's arguments and settings in each call of
    ``render()``."""
    calls = []
    real = lc.tss_shade_halfres

    def record(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    with monkeypatch.context() as m:
        m.setattr(lc, "tss_shade_halfres", record)
        render()
    return calls


def _frame_args(call):
    """A recorded call as (scene, chart_uv, uv, mat_id, light8, ah, aw,
    covered)."""
    args, kw = call
    assert kw["dither"] and kw["max_aniso"].max_taps == 16 and kw["y0"] == 0
    return (*args, kw["covered"])


@pytest.mark.gpu
def test_tss_shade_on_the_sponza_frame(cuda_device, monkeypatch):
    """The 1080p Sponza texture-space headline at pose 300 of the
    benchmark's orbit: one screen-pass launch a frame, eager and in every
    replay of the captured frame; its call (the raster's attribute planes
    read in place) kernel against plain bit for bit at every setting, a
    band starting on row 537 included; the whole eager frame equals the
    eager frame with the plain version monkeypatched in."""
    r = _tss_sponza_renderer()
    before = cr.launch_counts["tss_shade"]
    for _ in range(3):
        img, st = r.render()
    torch.cuda.synchronize()
    assert cr.launch_counts["tss_shade"] == before + 3
    assert _overflow_free(st)
    calls = _shade_calls(monkeypatch, r.render_eager)
    assert len(calls) == 1
    args = _frame_args(calls[0])
    assert args[1].shape[:2] == (1080, 1920) and not args[1].is_contiguous()
    for name in SHADE_SETTINGS:
        band, kw = _shade_band(args, name)
        _shade_exact(band[:7], covered=band[7], **kw)
    eager = r.render_eager()[0]
    assert torch.equal(eager, img)
    with monkeypatch.context() as m:
        m.setattr(lc, "tss_shade_halfres", lc.tss_shade_halfres_plain)
        plain = r.render_eager()[0]
    assert torch.equal(eager, plain)


@pytest.mark.gpu
def test_tss_shade_on_the_ssaa2_frame(cuda_device, monkeypatch):
    """The ``ssaa=2`` headline's screen-pass call (3840x2160), kernel
    against plain bit for bit, at its settings and with exact taps."""
    r = _tss_sponza_renderer(ssaa=2)
    calls = _shade_calls(monkeypatch, r.render_eager)
    assert len(calls) == 1
    args = _frame_args(calls[0])
    assert args[1].shape[:2] == (2160, 3840)
    for name in ("dither_aniso16", "exact_aniso16"):
        _shade_exact(args[:7], covered=args[7], **_shade_settings(name))


@pytest.mark.gpu
@pytest.mark.parametrize("tss", [False, True], ids=["per_pixel", "tss"])
def test_replays_count_the_tss_shade_launches(cuda_device, tss):
    """A replay of the captured frame adds the launches its eager frame
    makes: one screen-pass launch in the texture-space frame, none in the
    per-pixel frame."""
    r = FrameRenderer(_small_sponza(), _graph_cfg(tss))
    for _ in range(3):
        r.render()
        torch.cuda.synchronize()
    r._react_overflow = False
    before = cr.launch_counts["tss_shade"]
    r.render_eager()
    eager = cr.launch_counts["tss_shade"] - before
    assert eager == (1 if tss else 0)
    before = cr.launch_counts["tss_shade"]
    for _ in range(3):
        r.render()
    torch.cuda.synchronize()
    assert cr.launch_counts["tss_shade"] - before == 3 * eager


# --- the point-light cube shadow (the nave lamp's six faces) ---------------

DEPTH_ONLY = (0, False, False)   # K1's variant key of a shadow map launch


def _cube_renderer():
    """The benchmark's cube configuration (``sponza1080_tss_cube``: the
    texture-space headline over ``sponza_cube_scene``, 8 maps of 4096^2,
    the lamp's faces 2-7), its controller frozen after two frames."""
    r = FrameRenderer(
        procedural.sponza_cube_scene(width=1920, height=1080, n_textures=200,
                                     target_tris=260_000),
        RenderConfig(width=1920, height=1080, shadow_extent=4096,
                     debug_views=False, texture_space=True,
                     tss_preshaded_blend=True, dither_trilinear=True,
                     sky_halfres=True))
    for _ in range(2):
        r.render()
        torch.cuda.synchronize()
    r._react_overflow = False
    return r


@pytest.mark.gpu
def test_cube_shadow_replays_the_eager_pass(cuda_device):
    """Three shadow-dirty frames of the cube configuration replay the
    shadow program: 8 depth-only K1 launches each (the sun's and the
    spot's maps and the lamp's six faces; the texture-space frame's own
    passes run in K2), the stamped regions
    ``frame.shadow_cube`` and ``frame.vis_cube``, no pair dropped, and the
    packed maps the frame reads equal the eager pass's at the same
    transforms byte for byte; each face through K1 equals its plain
    raster bit for bit."""
    r = _cube_renderer()
    assert r.n_shadows == 8 and r._cube_bases == (2,)
    before = cr.variant_counts[DEPTH_ONLY]
    shadows = r.program_counts["shadow_replays"]
    for _ in range(3):
        r.mark_shadows_dirty()
        _, st = r.render()
    torch.cuda.synchronize()
    assert cr.variant_counts[DEPTH_ONLY] - before == 3 * 8
    # the replayed shadow and visibility programs stamp the cube's regions
    ns = dict(zip(profiling.STAMPED, st["pass_ns"].tolist()))
    assert 0 < ns["frame.shadow_cube"] < ns["frame.shadow"]
    assert 0 < ns["frame.vis_cube"] < ns["frame.tss_bake"]
    assert r.program_counts["shadow_replays"] == shadows + 3
    assert r.shadow_overflow == 0
    eager, sov = fr.render_shadow_pass(
        r.scene_dev, r._u, r.config, r.n_shadows, r.backend,
        max_pairs=r._shadow_budget_val, return_overflow=True,
        cube_bases=r._cube_bases)
    assert int(sov) == 0
    assert all(torch.equal(a, b) for a, b in zip(r._shadow_maps, eager))
    svp = fr.unpack_params(r._u, r.n_shadows)["shadow_viewproj"]
    for si in range(2, 8):
        s = fr.shadow_setup(r.scene_dev, svp[si], 4096)
        prep = cr.prepare_pairs(s, 4096, 4096,
                                max_pairs=r._shadow_budget_val)
        assert int(prep.bins.n_overflow) == 0
        b = prep.bins
        args = (prep.pair_data, b.starts, b.counts, 4096 // cr.TILE_W, 4096,
                4096, 0, 0)
        assert torch.equal(cr.raster_tiles(*args),
                           cr._raster_tiles_plain(*args)), si


@pytest.mark.gpu
def test_no_cube_face_without_a_point_light_shadow(cuda_device):
    """A ``sponza_scene`` renderer (the sun's and the spot's maps only)
    launches no cube face on its shadow-dirty frames: 2 depth-only K1
    launches a shadow pass (each replay, and each capture's warm-up), and
    its replayed frame stamps no cube region."""
    r = FrameRenderer(_small_sponza(), _graph_cfg(True))
    assert r._cube_bases == ()
    before = cr.variant_counts[DEPTH_ONLY]
    passes = (r.program_counts["shadow_replays"]
              + r.program_counts["shadow_captures"])
    for _ in range(3):
        r.mark_shadows_dirty()
        _, st = r.render()
    torch.cuda.synchronize()
    passes = (r.program_counts["shadow_replays"]
              + r.program_counts["shadow_captures"] - passes)
    assert passes >= 3
    assert cr.variant_counts[DEPTH_ONLY] - before == 2 * passes
    ns = dict(zip(profiling.STAMPED, st["pass_ns"].tolist()))
    assert ns["frame.shadow_cube"] == ns["frame.vis_cube"] == 0
