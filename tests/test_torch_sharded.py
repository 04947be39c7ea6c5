"""The sharded renderer (``parallel.sharded``) over ``torch.distributed``
with the gloo backend, one CPU process a rank, mirroring
tests/test_sharded.py: the gathered frame must equal the single-process
frame byte for byte, given the same budgets.

The ranks are processes spawned by ``tools.sharded_run.launch`` (which
imports the package only), meeting through a rendezvous file in the
test's own directory so parallel test workers never share a port; every
collective has a timeout and the launch a deadline, so a stuck rank fails
the test instead of hanging it. The 2-rank cases run in one launch (the
ranks render every case in turn) and the 8-rank case in another.

Against the JAX package's own 2-device sharded frame (conftest's CPU
mesh) the tolerance is the golden bar: within 1/255 on >= 99.9% of
pixels, max 4/255."""

import os

import jax
import numpy as np
import pytest
import torch

from renderengine_tpu.core.config import RenderConfig as JRenderConfig
from renderengine_tpu.parallel import sharded as jsharded
from renderengine_tpu.scene import procedural as jprocedural

from renderengine_tpu_torch.core.config import RenderConfig
from renderengine_tpu_torch.graph.frame import FrameRenderer
from renderengine_tpu_torch.parallel import sharded
from renderengine_tpu_torch.tools import goldens, sharded_run

torch.set_num_threads(2)

CUBE = ("cube_scene", dict(width=64, height=32))
SPONZA = ("sponza_scene", dict(width=64, height=32, n_textures=4,
                               target_tris=400))
WIDE = ("sponza_scene", dict(width=256, height=32, n_textures=4,
                             target_tris=400))
MIDTILE = ("sponza_scene", dict(width=64, height=40, n_textures=4,
                                target_tris=400))
WIDE_MIDTILE = ("sponza_scene", dict(width=256, height=40, n_textures=4,
                                     target_tris=400))

# TestCompactionShardInvariance.CASES of tests/test_sharded.py
COMPACTION = {
    "aniso_tiers": dict(max_anisotropy=16,
                        aniso_tile_fracs=(0.25, 0.15, 0.08),
                        translucency=False),
    "penumbra_budget": dict(max_anisotropy=1, translucency=False,
                            penumbra_tile_budget=4, shadow_extent=64),
    "blend_sparse_tiles": dict(max_anisotropy=1, translucency=True,
                               translucency_tile_fraction=0.9),
}

# name -> (scene, config, raster backend)
CASES = {
    "two_rank": (CUBE, dict(width=64, height=32, shadow_extent=32,
                            translucency=False), "reference"),
    "full_features": (SPONZA, dict(width=64, height=32, shadow_extent=32,
                                   grid=True), "cuda"),
    "texture_space": (SPONZA, dict(width=64, height=32, shadow_extent=32,
                                   translucency=True, debug_views=False,
                                   texture_space=True,
                                   tss_preshaded_blend=True,
                                   chart_density=1.0), "cuda"),
    "tss_headline": (SPONZA, dict(width=64, height=32, shadow_extent=32,
                                  debug_views=False, texture_space=True,
                                  tss_preshaded_blend=True,
                                  dither_trilinear=True, sky_halfres=True),
                     "cuda"),
    "midtile": (MIDTILE, dict(width=64, height=40, shadow_extent=32,
                              grid=True), "cuda"),
}
# each compaction at 256x32 (16-row bands) and at 256x40 (20-row bands:
# the second starts 4 rows into a tile). At 256x40 the blend fraction of
# 0.9 keeps every tile (2 a tile row), so that case takes 0.5 (1 a row)
# to drop work there
for _name, _kw in COMPACTION.items():
    for _spec, _suffix in ((WIDE, ""), (WIDE_MIDTILE, "_midtile")):
        _cfg = dict(width=256, height=_spec[1]["height"], shadow_extent=32,
                    debug_views=False)
        _cfg.update(_kw)
        if _suffix and "translucency_tile_fraction" in _kw:
            _cfg["translucency_tile_fraction"] = 0.5
        CASES[f"compaction_{_name}{_suffix}"] = (_spec, _cfg, "reference")


def _single(scene_spec, cfg_kw, backend, drops=False):
    """The single-process frame, its renderer (budgets, shadow maps).
    Every overflow counter is 0 unless the case may drop work on purpose
    (``drops``: the compaction cases' small budgets)."""
    r = FrameRenderer(sharded_run.scene_from_spec(scene_spec),
                      RenderConfig(**cfg_kw), device="cpu", backend=backend)
    img, st = r.render()
    assert drops or not any(int(v) for k, v in st.items() if "overflow" in k)
    return img, r, st


def _run(scene_spec, r, backend, keep=False):
    return {"scene": scene_spec, "config": r.config, "backend": backend,
            "shadow_budget": r._shadow_budget_val, "frames": 1,
            "keep_shadow_maps": keep}


def _launch(tmp, world, runs):
    return sharded_run.launch(
        {"dist_backend": "gloo", "world": world, "devices": ["cpu"] * world,
         "runs": runs}, tmp, timeout_s=240)


@pytest.fixture(scope="module")
def two_rank(tmp_path_factory):
    singles, runs = {}, {}
    for name, (spec, kw, backend) in CASES.items():
        img, r, st = _single(spec, kw, backend,
                             name.startswith("compaction"))
        singles[name] = (img, r._shadow_maps, r.config, st)
        runs[name] = _run(spec, r, backend, keep=True)
    out = _launch(tmp_path_factory.mktemp("two_rank"), 2, runs)
    return singles, out["ranks"]


def _mismatch(a, b):
    return float((a != b).float().mean())


@pytest.mark.parametrize("name", [n for n in CASES
                                  if not n.startswith("compaction")])
def test_two_ranks_match_single(two_rank, name):
    """2 ranks equal the single frame: the cube on the brute-force raster;
    the Sponza with translucency, grid, skybox and shadows through K1's
    plain version; texture-space shading through K2's (the chart specular
    pass on each rank's atlas rows) and the headline texture-space config
    (half-res sky and light: the bands render the halo); and bands that
    start mid-tile (40 rows: the second band starts at row 20)."""
    singles, ranks = two_rank
    img = singles[name][0]
    got = ranks[0]["runs"][name]
    assert got["frame"].shape == img.shape
    assert _mismatch(got["frame"], img) == 0.0, name
    for rk in ranks:
        rec = rk["runs"][name]
        assert not any(v for k, v in rec["stats"].items() if "overflow" in k)
        assert rec["shadow_overflow"] == 0
        assert rk["transport"] == "gloo"
    # the bands' counters as whole-frame ones: the busiest band's tiles
    if "blend_shade_tiles" in got["stats"]:
        assert len(got["stats"]["blend_shade_tiles"]) == 2


@pytest.mark.parametrize("case", sorted(COMPACTION))
def test_compaction_shard_invariance(two_rank, case):
    """Each screen-space compaction on, at budgets small enough that the
    selection drops work: two ranks equal the single frame exactly."""
    singles, ranks = two_rank
    name = f"compaction_{case}"
    assert _mismatch(ranks[0]["runs"][name]["frame"], singles[name][0]) \
        == 0.0, case


@pytest.mark.parametrize("case", sorted(COMPACTION))
def test_compaction_midtile_band_invariance(two_rank, case):
    """The compactions on 20-row bands (the second starts 4 rows into an
    8-row tile), the penumbra and blend-tile budgets dropping work in the
    single frame: the bands render whole tile rows (``band_extent``), so
    every per-tile-row selection is the whole frame's and two ranks equal
    the single frame exactly."""
    singles, ranks = two_rank
    name = f"compaction_{case}_midtile"
    assert singles[name][2].height == 40
    dropped = {"penumbra_budget": "penumbra_overflow",
               "blend_sparse_tiles": "blend_pair_overflow"}.get(case)
    if dropped:
        assert int(singles[name][3][dropped]) > 0
    assert _mismatch(ranks[0]["runs"][name]["frame"], singles[name][0]) \
        == 0.0, case


@pytest.mark.parametrize("name", ["full_features", "tss_headline"])
def test_sharded_shadow_maps_equal_single(two_rank, name):
    """Each rank rasters half the triangles into the full maps; the
    all_reduce(MIN) merge packs to the single-process blocks and coarse
    cells exactly."""
    singles, ranks = two_rank
    want = singles[name][1]
    got = ranks[0]["runs"][name]["shadow_maps"]
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


EIGHT = {
    # 64x32: 4-row bands
    "eight": (("sponza_scene", dict(width=64, height=32, n_textures=4,
                                    target_tris=600)),
              dict(width=64, height=32, shadow_extent=32)),
    # 64x40 in the headline texture-space config: 5-row bands, odd and
    # off the 4-row dither pattern, with the half-res sky and light
    "eight_odd": (MIDTILE, CASES["tss_headline"][1] | dict(height=40)),
}


@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory):
    singles, runs = {}, {}
    for name, (spec, kw) in EIGHT.items():
        img, r, _ = _single(spec, kw, "cuda")
        singles[name] = img
        runs[name] = _run(spec, r, "cuda")
    out = _launch(tmp_path_factory.mktemp("eight_ranks"), 8, runs)
    return singles, out["ranks"]


def test_eight_ranks_run(eight_ranks):
    """8 ranks (4-row bands) render the Sponza; the frame is the single
    frame, byte for byte."""
    singles, ranks = eight_ranks
    frame = ranks[0]["runs"]["eight"]["frame"]
    assert frame.shape == (32, 64, 4) and frame.any()
    assert _mismatch(frame, singles["eight"]) == 0.0
    assert [rk["rank"] for rk in ranks] == list(range(8))


def test_eight_ranks_odd_bands(eight_ranks):
    """8 ranks at 40 rows (5-row bands, most starting mid-tile and off
    the dither pattern) in the headline texture-space config: the frame
    is the single frame, byte for byte."""
    singles, ranks = eight_ranks
    frame = ranks[0]["runs"]["eight_odd"]["frame"]
    assert frame.shape == (40, 64, 4) and frame.any()
    assert _mismatch(frame, singles["eight_odd"]) == 0.0
    for rk in ranks:
        rec = rk["runs"]["eight_odd"]
        assert not any(v for k, v in rec["stats"].items() if "overflow" in k)


def test_against_the_jax_sharded_frame(two_rank):
    """The JAX package's own 2-device sharded frame of the cube (its
    ``tiled`` backend on conftest's CPU mesh) against the port's 2-rank
    frame: the golden bar."""
    w, h = 64, 32
    sc = jprocedural.cube_scene(width=w, height=h)
    cfg = JRenderConfig(width=w, height=h, shadow_extent=32,
                        translucency=False)
    fn, scene_dev, params_builder = jsharded.build_sharded_renderer(
        sc, cfg, jsharded.make_mesh(2), backend="tiled")
    jimg = np.asarray(fn(jax.device_put(scene_dev), params_builder()))
    ours = two_rank[1][0]["runs"]["two_rank"]["frame"].numpy()
    frac, mx = goldens.golden_bar(ours, jimg)
    assert goldens.meets_bar(frac, mx), (frac, mx)


def _group(tmp_path):
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
        world_size=1, rank=0)


def test_mesh_refuses_another_world_and_no_card(tmp_path, monkeypatch):
    """``make_mesh`` refuses a world size other than the group's and,
    with no device given, the CPU: None means ``cuda``."""
    with pytest.raises(RuntimeError, match="initialized process group"):
        sharded.make_mesh(1, device="cpu")
    _group(tmp_path)
    try:
        with pytest.raises(RuntimeError, match="fake multi-card"):
            sharded.make_mesh(2, device="cpu")
        mesh = sharded.make_mesh(1, device="cpu")
        assert (mesh.world, mesh.rank, mesh.transport) == (1, 0, "gloo")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharded.make_mesh(1)
    finally:
        torch.distributed.destroy_process_group()


def test_world_one_equals_the_frame_renderer(tmp_path):
    """A world of one through the same code (every collective runs) is
    the ``FrameRenderer`` frame, also through ``build_sharded_renderer``
    (the JAX package's (fn, scene_dev, params_builder) form); the shadow
    overflow is counted."""
    img, r, _ = _single(*CASES["full_features"])
    _group(tmp_path)
    try:
        mesh = sharded.make_mesh(1, device="cpu")
        sr = sharded.ShardedRenderer(
            sharded_run.scene_from_spec(SPONZA), r.config, mesh,
            shadow_budget=r._shadow_budget_val)
        frame, st = sr.render()
        assert torch.equal(frame, img) and sr.shadow_overflow == 0
        assert not any(int(v) for k, v in st.items() if "overflow" in k)
        fn, scene_dev, params_builder = sharded.build_sharded_renderer(
            sharded_run.scene_from_spec(SPONZA), r.config, mesh)
        assert torch.equal(fn(scene_dev, params_builder()), img)
    finally:
        torch.distributed.destroy_process_group()


def test_band_heights_are_refused():
    """A height that does not divide over the ranks, and bands that would
    split SSAA pixels, are refused before any collective (any other band
    height renders: ``test_eight_ranks_odd_bands``)."""
    cfg = RenderConfig(width=64, height=32)
    mesh = sharded.Mesh(3, 0, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="divide over 3"):
        sharded.render_frame_sharded({}, {}, None, cfg, 0, mesh, local={})
    mesh = sharded.Mesh(16, 0, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="split SSAA pixels"):
        sharded.render_frame_sharded({}, {}, None,
                                     cfg.replace(height=40, ssaa=2), 0, mesh,
                                     local={})


def test_rank_failure_fails_the_launch(tmp_path):
    """A rank that raises fails the launch with its log, and the launch
    stops the rank still waiting in the rendezvous."""
    runs = {"bad": {"scene": ("no_such_scene", {}),
                    "config": RenderConfig(width=8, height=8), "frames": 1}}
    with pytest.raises(RuntimeError, match="no_such_scene"):
        sharded_run.launch({"dist_backend": "gloo", "world": 2,
                            "devices": ["cpu", "cpu"], "runs": runs},
                           tmp_path, timeout_s=120)
    assert not os.path.exists(tmp_path / "rank0.pt")
