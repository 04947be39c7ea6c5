"""The port's runtime around the frame: ``RenderLoop`` (two frames in
flight, resize), the overflow controller of ``FrameRenderer`` (queued
counters, the non-blocking poll and its queue rule, growth on overflow,
the shrinking re-tunes from observed coverage) held decision for decision
to the JAX package's, the absence of the JAX package's tuned-config
record, ``core/engine.py`` and ``utils/profiling.py``. Everything runs on the CPU, where a queued entry
is ready at once; the card's pinned copies and events are exercised by
tests/test_torch_gpu.py and chip_smoke.py.

Tolerances: frames exact (the same renderer code on the same inputs);
budgets and controller state exactly equal to the JAX package's; a
shade-budget re-tune moves pixels within 2/255 where the JAX package's
moves them (ROADMAP F9)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from renderengine_tpu.core.config import RasterConfig as JRasterConfig
from renderengine_tpu.core.config import RenderConfig as JRenderConfig
from renderengine_tpu.graph import frame as jframe
from renderengine_tpu.scene import procedural as jproc

from renderengine_tpu_torch.core import engine
from renderengine_tpu_torch.core.aabb import AABB
from renderengine_tpu_torch.core import math3d
from renderengine_tpu_torch.core.config import RasterConfig, RenderConfig
from renderengine_tpu_torch.graph.frame import FrameRenderer
from renderengine_tpu_torch.graph.render_loop import (MAX_FRAMES_IN_FLIGHT,
                                                      RenderLoop)
from renderengine_tpu_torch.scene import procedural
from renderengine_tpu_torch.scene.camera import Camera
from renderengine_tpu_torch.scene.lights import Light, LightType
from renderengine_tpu_torch.scene.materials import (MaterialInstanceInfo,
                                                    MaterialProperties)
from renderengine_tpu_torch.scene.scene import Scene
from renderengine_tpu_torch.utils import profiling

torch.set_num_threads(2)


class TestRenderLoop:
    def test_frames_in_flight_and_resize(self):
        """Mirrors tests/test_render_loop.py: the in-flight window bounds
        un-presented frames; resize builds a renderer at the new extent."""
        sc = procedural.cube_scene(width=64, height=48)
        cfg = RenderConfig(width=64, height=48, shadow_extent=32,
                           translucency=False)
        presented = []
        loop = RenderLoop(sc, cfg, on_present=presented.append,
                          target_fps=0.0, device="cpu")
        for _ in range(MAX_FRAMES_IN_FLIGHT + 2):
            loop.render_one()
        assert len(presented) == 2
        loop.drain()
        assert len(presented) == MAX_FRAMES_IN_FLIGHT + 2
        assert presented[0].shape == (48, 64, 4)
        assert presented[0].dtype == np.uint8
        old = loop.renderer
        loop.resize(96, 32)
        assert loop.renderer is not old and loop.renderer.device.type == "cpu"
        loop.render_one()
        loop.drain()
        assert presented[-1].shape == (32, 96, 4)
        assert loop.renderer.config.width == 96

    def test_loop_frames_equal_sequential_frames(self):
        """An orbiting camera through the loop presents, in order, the
        frames a renderer gives one at a time; ``run`` stops when
        ``on_update`` says so."""
        sc = procedural.cube_scene(width=48, height=32)
        cfg = RenderConfig(width=48, height=32, shadow_extent=32,
                           translucency=False)
        eyes = [np.array([3.0 * np.cos(a), 2.0, 3.0 * np.sin(a)], np.float32)
                for a in np.linspace(0, 1.5, 5)]
        presented = []
        step = {"i": 0}

        def on_update(dt):
            if step["i"] == len(eyes):
                return False
            sc.camera.set_camera_view(eyes[step["i"]], np.zeros(3),
                                      np.array([0, 1, 0]))
            step["i"] += 1
            return True

        RenderLoop(sc, cfg, on_update=on_update,
                   on_present=lambda f: presented.append(f.copy()),
                   target_fps=0.0, device="cpu").run(max_frames=50)
        r = FrameRenderer(sc, cfg, device="cpu")
        assert len(presented) == len(eyes)
        for eye, got in zip(eyes, presented):
            sc.camera.set_camera_view(eye, np.zeros(3), np.array([0, 1, 0]))
            np.testing.assert_array_equal(got, r.render()[0].numpy())


def _dense_scene(w, h, n_quads=3000):
    """Mirrors tests/test_overflow_react.py: many screen-filling quads
    stacked in depth, nearest last (budget overflow drops high ids)."""
    sc = Scene()
    plane = procedural.make_plane(0.5, normal_axis=2)
    rng = np.random.default_rng(7)
    for i in range(n_quads):
        mat = sc.materials.create_material_instance(MaterialInstanceInfo(
            MaterialProperties(
                base_color=np.array([*rng.uniform(0.2, 1.0, 3), 1.0],
                                    np.float32))))
        z = -10.0 + 8.0 * (i + 1) / n_quads
        node = sc.tree.create_node(
            math3d.translate([0, 0, z]) @ math3d.scale([20, 20, 1]),
            AABB.from_points([[-0.5, -0.5, 0], [0.5, 0.5, 0]]))
        p, n, u, idx = plane
        base = sc.meshes.add_vertices(p, n, u)
        sc.meshes.add_mesh(idx + base, mat, node)
    sc.lights.add_light(Light(type=LightType.DIRECTIONAL,
                              color=np.ones(3, np.float32),
                              direction=math3d.normalize([0.0, -0.3, -1.0]),
                              intensity=3.0))
    sc.camera = Camera(eye=np.array([0, 0, 2.0], np.float32),
                       look_at=np.array([0, 0, -5.0], np.float32),
                       up=np.array([0, 1, 0], np.float32),
                       fov_degrees=60.0, near=0.1, far=100.0,
                       width=w, height=h, exposure=1.0)
    return sc


def _dense_cfg(w, h):
    return RenderConfig(
        width=w, height=h, shadows=False, skybox=False, translucency=False,
        raster=RasterConfig(pairs_per_tri=2, auto_tune_pairs=False))


class TestOverflowReaction:
    """Mirrors tests/test_overflow_react.py on the port's poll."""

    def test_overflow_triggers_retune_and_recovers(self):
        w, h = 64, 48
        sc = _dense_scene(w, h)
        ref, _ = FrameRenderer(sc, _dense_cfg(w, h), device="cpu",
                               backend="reference").render()
        r = FrameRenderer(sc, _dense_cfg(w, h), device="cpu")
        r._react_overflow = True
        before = r.config.raster.pairs_per_tri
        img0, st = r.render()
        assert int(st["pair_overflow"]) > 0, "setup failed to overflow"
        assert (img0 != ref).any(), "expected dropped geometry pre-retune"
        for _ in range(6):
            img, st = r.render()
            if torch.equal(img, ref):
                break
        assert r.config.raster.pairs_per_tri > before
        assert torch.equal(img, ref)
        assert int(st["pair_overflow"]) == 0

    def test_absolute_budget_growth(self):
        w, h = 64, 48
        sc = _dense_scene(w, h, n_quads=1200)
        ref, _ = FrameRenderer(sc, _dense_cfg(w, h), device="cpu",
                               backend="reference").render()
        r = FrameRenderer(sc, _dense_cfg(w, h), device="cpu")
        r.config = r.config.replace(raster=dataclasses.replace(
            r.config.raster, pair_budget=4096))
        r._react_overflow = True
        r.render()
        for _ in range(8):
            img, st = r.render()
            if torch.equal(img, ref):
                break
        assert r.config.raster.pair_budget > 4096
        assert torch.equal(img, ref)
        assert int(st["pair_overflow"]) == 0


class _Event:
    """A stand-in for ``torch.cuda.Event``: not ready until waited on."""

    def __init__(self, ready=False):
        self.ready, self.waited = ready, 0

    def query(self):
        return self.ready

    def synchronize(self):
        self.waited += 1
        self.ready = True


def _stats(pair=0, tail=0, blend=0, layers=(0, 0), pen=0, pen_ov=0):
    return {"pair_overflow": pair, "pair_tail_overflow": tail,
            "blend_pair_overflow": blend,
            "blend_shade_tiles": np.asarray(layers, np.int64),
            "penumbra_tiles": pen, "penumbra_overflow": pen_ov}


def _queue(r, st, event=None):
    r._queue_stats({k: torch.as_tensor(v) for k, v in st.items()})
    if event is not None:
        entry, _ = r._pending_overflow.pop()
        r._pending_overflow.append((entry, event))


class TestPollQueue:
    def _renderer(self):
        cfg = RenderConfig(width=64, height=48, shadow_extent=32,
                           translucency=False, penumbra_tile_budget=4)
        r = FrameRenderer(procedural.cube_scene(width=64, height=48), cfg,
                          device="cpu")
        assert r._react_overflow
        return r

    def test_cpu_entries_are_ready_and_round_trip(self):
        r = self._renderer()
        _queue(r, _stats(pair=3, layers=(5, 7), pen=9))
        (entry, ev), = r._pending_overflow
        assert ev is None
        st = r._read_stats(entry)
        assert st["pair_overflow"] == 3 and st["penumbra_tiles"] == 9
        np.testing.assert_array_equal(st["blend_shade_tiles"], [5, 7])
        r._poll_overflow()
        assert not r._pending_overflow

    def test_stops_at_an_unready_head(self):
        """The poll consumes finished frames in order and stops at the
        first unfinished one without waiting on it."""
        r = self._renderer()
        evs = [_Event(True), _Event(False), _Event(True)]
        for ev in evs:
            _queue(r, _stats(layers=(3, 1), pen=2), ev)
        r._poll_overflow()
        assert len(r._pending_overflow) == 2
        assert r._pending_overflow[0][1] is evs[1]
        assert not any(ev.waited for ev in evs)
        assert len(r._pen_obs) == 1

    def test_waits_only_past_sixteen(self):
        """With more than 16 frames queued the poll waits on the oldest
        (a memory backstop), then stops at the next unfinished one."""
        r = self._renderer()
        evs = [_Event(False) for _ in range(17)]
        for ev in evs:
            _queue(r, _stats(layers=(3, 1), pen=2), ev)
        r._poll_overflow()
        assert [ev.waited for ev in evs] == [1] + [0] * 16
        assert len(r._pending_overflow) == 16
        evs[1].ready = True
        r._poll_overflow()
        assert len(r._pending_overflow) == 15 and evs[1].waited == 0

    def test_growth_drops_the_rest_unread(self):
        """After a growth the queued frames rendered with the old budgets
        are dropped unread, as in the JAX package."""
        r = self._renderer()
        _queue(r, _stats(pen=20, pen_ov=5))
        _queue(r, _stats(pen=1, pen_ov=9), _Event(False))
        r._poll_overflow()
        assert not r._pending_overflow
        assert r.config.penumbra_tile_budget == 6    # min(total 6, ...)
        assert r._pen_obs == []


def _controllers():
    """The port's and the JAX package's controllers on one tiny scene at a
    1024x512 config (512 shade tiles): nothing renders, observations are
    fed in."""
    kw = dict(width=1024, height=512, shadow_extent=32,
              penumbra_tile_budget=300, blend_pair_budget=4000,
              blend_tile_budget=200, translucency_tile_fraction=0.25)
    rk = dict(auto_tune_pairs=False, pairs_per_tri=2, pair_budget=5000,
              dense_k=4)
    mine = FrameRenderer(procedural.cube_scene(width=64, height=48),
                         RenderConfig(**kw, raster=RasterConfig(**rk)),
                         device="cpu")
    ref = jframe.FrameRenderer(jproc.cube_scene(width=64, height=48),
                               JRenderConfig(**kw,
                                             raster=JRasterConfig(**rk)),
                               backend="reference")
    for r in (mine, ref):
        r._react_overflow = True
    return mine, ref


def _state(r):
    c = r.config
    return (c.blend_layer_tile_budgets, c.penumbra_tile_budget,
            c.blend_pair_budget, c.blend_tile_budget,
            c.translucency_tile_fraction, c.raster.pair_budget,
            c.raster.pairs_per_tri, c.raster.dense_k,
            tuple(r._blend_floor), r._pen_floor, r._pen_tuned,
            r._polls_since_blend_retune, r._polls_since_pen_retune,
            len(r._blend_obs), len(r._pen_obs))


def _observations(rng, n):
    """Per poll, 1-3 frames of counters: busy then quiet stretches (so
    first tunes, 64-poll shrinks and floor decay all happen), blend and
    penumbra overflows, pair and big-list overflows."""
    for i in range(n):
        quiet = (i // 90) % 2 == 1
        frames = []
        for _ in range(int(rng.integers(1, 4)) if i % 11 == 0 else 1):
            l1 = int(rng.integers(8, 40) if quiet else rng.integers(60, 200))
            l2 = int(rng.integers(0, 12) if quiet else rng.integers(20, 90))
            pen = int(rng.integers(10, 60) if quiet else rng.integers(80, 320))
            frames.append(_stats(
                pair=int(rng.integers(1, 900)) if rng.random() < 0.03 else 0,
                tail=int(rng.integers(1, 50)) if rng.random() < 0.02 else 0,
                blend=int(rng.integers(1, 40)) if rng.random() < 0.05 else 0,
                layers=(l1, l2), pen=pen,
                pen_ov=int(rng.integers(1, 30)) if rng.random() < 0.04
                else 0))
        yield frames


def test_retune_decisions_equal_jax():
    """The same 400 polls of counters through both controllers: every
    budget and every piece of controller state equal after each poll."""
    mine, ref = _controllers()
    rng = np.random.default_rng(5)
    changes = set()
    for i, frames in enumerate(_observations(rng, 400)):
        for st in frames:
            _queue(mine, st)
            ref._pending_overflow.append(
                {k: np.asarray(v, np.int64) for k, v in st.items()})
        mine._poll_overflow()
        ref._poll_overflow()
        a, b = _state(mine), _state(ref)
        assert a == b, (i, a, b)
        changes.add(a[:8])
    # the sequence exercised the controller: first tunes, growth, shrinks
    assert len(changes) > 10
    assert mine._blend_floor and mine._pen_floor


def test_no_tuned_record_is_read_or_written(tmp_path, monkeypatch):
    """The port keeps no tuned-config record: with the JAX package's
    switch on and a ``tuned_configs.json`` of absurd budgets where the
    record used to live, a renderer still sizes its budgets with its
    estimators, ends with the config of a renderer built with no file
    present, and writes nothing."""
    monkeypatch.setenv("RENDERENGINE_TUNED_CACHE", "1")
    monkeypatch.setenv("RENDERENGINE_TORCH_CACHE_DIR", str(tmp_path))
    absurd = {"pairs_per_tri": 1, "pair_budget": 7, "dense_k": 99,
              "translucency_tile_fraction": 1e-6, "penumbra_tile_budget": 3,
              "blend_pair_budget": 5, "blend_tile_budget": 2,
              "blend_layer_tile_budgets": [1, 1], "shadow_budget": 11}
    path = tmp_path / "tuned_configs.json"
    path.write_text(json.dumps({f"{k:032x}": absurd for k in range(64)}))
    before = path.read_text()
    called = []
    for name in ("_estimate_pair_budget", "_estimate_shadow_budget"):
        def counted(self, *a, _fn=getattr(FrameRenderer, name), _n=name):
            called.append(_n)
            return _fn(self, *a)
        monkeypatch.setattr(FrameRenderer, name, counted)
    cfg = RenderConfig(width=64, height=48, shadow_extent=1024,
                       translucency=False)
    r = FrameRenderer(procedural.cube_scene(width=64, height=48), cfg,
                      device="cpu")
    r.render()
    r.render()
    assert sorted(called) == ["_estimate_pair_budget",
                              "_estimate_shadow_budget"]
    assert [p.name for p in tmp_path.iterdir()] == ["tuned_configs.json"]
    assert path.read_text() == before
    path.unlink()
    fresh = FrameRenderer(procedural.cube_scene(width=64, height=48), cfg,
                          device="cpu")
    fresh.render()
    fresh.render()
    assert r.config == fresh.config
    assert r._shadow_budget_val == fresh._shadow_budget_val
    assert r.config.raster.pair_budget != absurd["pair_budget"]
    assert not any(tmp_path.iterdir())


class TestEngineAndProfiling:
    def test_init_and_device_info(self, monkeypatch):
        assert engine.init("cpu") == torch.device("cpu")
        assert engine.device_info("cpu")["platform"] == "cpu"
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            engine.init()

    def test_profiling_on_the_cpu(self, tmp_path):
        cfg = RenderConfig(width=32, height=24, shadow_extent=32,
                           translucency=False)
        r = FrameRenderer(procedural.cube_scene(width=32, height=24), cfg,
                          device="cpu")
        with profiling.trace(str(tmp_path / "tr")) as prof:
            r.render()
        assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
        assert any(e.key == "frame.shade" for e in prof.key_averages())


def test_shade_budget_retune_moves_pixels_as_in_jax():
    """ROADMAP F9: a per-layer shade budget below the tile count sends a
    peeled layer through ``shade_sparse``, whose compacted image gives the
    tiered aniso sampler another per-row segment budget than the full
    frame, so a re-tune that drops nothing still moves a few pixels. The
    JAX package's frame moves the same pixels by the same amount: the
    port's changed pixels are within 2/255 and at least 95% of them are
    the JAX frame's changed pixels (measured 375 and 374 pixels of 73728,
    max 2/255, 373 in common)."""
    w, h = 384, 192
    kw = dict(width=w, height=h, shadow_extent=512)
    mine = FrameRenderer(procedural.sponza_scene(
        width=w, height=h, n_textures=8, target_tris=20_000),
        RenderConfig(**kw), device="cpu")
    ref = jframe.FrameRenderer(jproc.sponza_scene(
        width=w, height=h, n_textures=8, target_tris=20_000),
        JRenderConfig(**kw))
    mine._react_overflow = ref._react_overflow = False   # budgets as set
    n = mine._shade_tile_total()
    frames = {}
    for budgets in ((), (n - 1, n - 1)):
        mine.config = mine.config.replace(blend_layer_tile_budgets=budgets)
        ref.config = ref.config.replace(blend_layer_tile_budgets=budgets)
        ref._rebuild_frame_fn()
        img, st = mine.render()
        assert not any(int(v) for k, v in st.items() if "overflow" in k)
        frames[budgets] = (img.numpy(), np.asarray(ref.render()))
    moved = []
    for i in (0, 1):
        a, b = frames[()][i], frames[(n - 1, n - 1)][i]
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 2
        moved.append((a != b).any(-1))
    assert moved[0].sum() > 0 and moved[1].sum() > 0
    assert (moved[0] & moved[1]).sum() >= 0.95 * moved[0].sum()
