"""The tracing inside the port's frame (``utils/profiling.py``): the spans
(``frame.*`` passes, ``host.*`` stages), the device clock stamps of the
passes that a captured frame keeps, the host-sync counter, the per-frame
records of ``profiling.frame_trace()`` and the per-layer readers of the
benchmark that read them.

On the CPU a stamp is the host clock, so the whole path runs here; the
``gpu`` case holds the stamps of a replayed frame on the card. This file
imports no JAX:

    python -m pytest --noconftest -q -m gpu tests/test_torch_trace.py
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from renderengine_tpu_torch.core.config import RenderConfig
from renderengine_tpu_torch.graph.frame import FrameRenderer
from renderengine_tpu_torch.graph.render_loop import RenderLoop
from renderengine_tpu_torch.scene import procedural
from renderengine_tpu_torch.utils import profiling

_BASE = RenderConfig(width=128, height=96, shadow_extent=256)
_TSS = _BASE.replace(debug_views=False, texture_space=True,
                     tss_preshaded_blend=True, dither_trilinear=True,
                     sky_halfres=True)
# the regions each configuration enters on a shadow-dirty frame (the
# procedural Sponza has translucent banners; no alpha-mask pass runs; the
# texture-space frame rasters its opaque pass and first two peel layers in
# one merged launch, and its ``frame.peel_raster`` launches nothing)
_REGIONS = {
    "per_pixel": {"frame", "frame.setup", "frame.bin_pack", "frame.raster",
                  "frame.shade", "frame.peel_raster", "frame.peel_shade",
                  "frame.encode", "frame.shadow"},
    "tss": {"frame", "frame.tss_spec", "frame.setup", "frame.bin_pack",
            "frame.merged_raster", "frame.shade", "frame.peel_raster",
            "frame.peel_shade", "frame.encode", "frame.shadow",
            "frame.tss_bake"},
}
# the stamped regions of the raster passes and of the resolve and encode
_NEW_REGIONS = ("frame.merged_raster", "frame.raster", "frame.peel_raster",
                "frame.encode")
_CONFIGS = {"per_pixel": _BASE, "tss": _TSS}


@pytest.fixture(scope="module")
def scene():
    return procedural.sponza_scene(width=128, height=96, n_textures=8,
                                   target_tris=2_000)


class _Ranges:
    """A stand-in profiler session: the profiler's flag on, and every
    ``record_function`` the port's modules hold replaced by a recorder of
    (name, start ns, end ns). A real session would also record every
    operator of the CPU frame, which takes minutes to parse."""

    def __init__(self, monkeypatch):
        import sys
        import time

        self.ranges = []
        outer = self

        class Range:
            def __init__(self, name, *a, **k):
                self.name = name

            def __enter__(self):
                self.t0 = time.perf_counter_ns()
                return self

            def __exit__(self, *exc):
                outer.ranges.append((self.name, self.t0,
                                     time.perf_counter_ns()))
                return False

        self.Range = Range
        for name, mod in list(sys.modules.items()):
            if name.startswith("renderengine_tpu_torch") and \
                    getattr(mod, "record_function", None) is record_function:
                monkeypatch.setattr(mod, "record_function", Range)
        monkeypatch.setattr(torch.profiler, "record_function", Range)
        monkeypatch.setattr(torch.autograd.profiler, "record_function", Range)
        self._mp = monkeypatch

    def __call__(self, fn):
        """``fn()`` inside the session, itself a range ``test.call``."""
        self._mp.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                         True)
        try:
            with self.Range("test.call"):
                return fn()
        finally:
            self._mp.setattr(torch.autograd.profiler,
                             "_is_profiler_enabled", False)

    def names(self) -> set:
        return {n for n, _, _ in self.ranges} - {"test.call"}


@pytest.mark.parametrize("ssaa", [1, 2])
def test_the_raster_and_resolve_are_stamped(scene, ssaa):
    """The raster passes and ``frame.encode`` (with ``ssaa`` 2 the box
    resolve and the sRGB encode) are stamped regions, one slot each of
    the frame's counter ``pass_ns``; a texture-space frame enters each
    but ``frame.raster`` (its merged launch rasters the opaque pass),
    inside the frame's span."""
    assert set(_NEW_REGIONS) <= set(profiling.STAMPED)
    assert len(set(profiling.STAMPED)) == len(profiling.STAMPED)
    r = FrameRenderer(scene, _TSS.replace(ssaa=ssaa), device="cpu")
    img, st = r.render()
    assert img.shape == (96, 128, 4)
    ns = dict(zip(profiling.STAMPED, st["pass_ns"].tolist()))
    assert st["pass_ns"].shape == (len(profiling.STAMPED),)
    assert ns["frame.raster"] == 0
    assert all(ns[n] > 0 for n in _NEW_REGIONS if n != "frame.raster"), ns
    own = sum(v for k, v in ns.items()
              if k not in ("frame", "frame.shadow", "frame.tss_bake"))
    assert own <= ns["frame"]


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_profiled_frame_leaves_one_record(scene, monkeypatch, name):
    """A shadow-dirty ``render()`` under a profiler session leaves one
    record: device ms for every stamped region its configuration enters
    (0 for the others), and the host ms of each ``host.*`` span, whose
    ranges lie inside the call."""
    session = _Ranges(monkeypatch)
    r = FrameRenderer(scene, _CONFIGS[name], device="cpu")
    r.render()
    r.mark_shadows_dirty()
    session(r.render)
    recs = profiling.frame_trace()
    assert len(recs) == 1
    rec = recs[0]
    assert rec["dirty"] and not rec["replayed"] and rec["syncs"] == 1
    assert rec["device_ms"] is None      # the counters are not polled yet
    r.render()                           # outside the session: no record
    assert len(profiling.frame_trace()) == 1
    dev = rec["device_ms"]
    assert set(dev) == set(profiling.STAMPED)
    assert {k for k, v in dev.items() if v > 0} == _REGIONS[name]
    seen = session.names()
    assert _REGIONS[name] - {"frame"} <= seen
    assert set(rec["host_ms"]) == {n for n in seen if n.startswith("host.")}
    assert {"host.shadow_fit", "host.upload", "host.shadow_read",
            "host.queue_stats"} <= set(rec["host_ms"])
    assert all(v >= 0 for v in rec["host_ms"].values())
    (_, a, b), = [h for h in session.ranges if h[0] == "test.call"]
    assert all(a <= s and e <= b for n, s, e in session.ranges
               if n.startswith("host."))
    # the regions of the frame program lie inside its span
    own = [v for k, v in dev.items()
           if k not in ("frame", "frame.shadow", "frame.tss_bake")]
    assert 0 < sum(own) <= dev["frame"]


def test_a_torch_profiler_session_leaves_records_and_ranges(scene):
    """Under ``torch.profiler`` itself: the record, and the spans as the
    profiler's ranges."""
    r = FrameRenderer(scene, _TSS, device="cpu")
    r.render()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.render()
    r.render()
    rec, = profiling.frame_trace()
    assert rec["device_ms"]["frame.shade"] > 0
    names = {e.name for e in prof.events()
             if getattr(e, "is_user_annotation", False)}
    assert {"frame.shade", "frame.tss_spec", "host.upload",
            "host.queue_stats"} <= names
    assert set(rec["host_ms"]) == {n for n in names if n.startswith("host.")}


def test_without_a_profiler_render_leaves_no_record_and_opens_no_range(
        scene, monkeypatch):
    session = _Ranges(monkeypatch)
    r = FrameRenderer(scene, _TSS, device="cpu")
    r.mark_shadows_dirty()
    img, st = r.render()
    r.render()
    assert not session.ranges and profiling.frame_trace() == []
    # the stamps run all the same: the frame's counter holds them
    assert st["pass_ns"].shape == (len(profiling.STAMPED),)
    assert int(st["pass_ns"][0]) > 0


def test_every_range_is_a_host_span_or_a_frame_pass(scene, monkeypatch):
    """Every range the port opens (an eager default frame, a texture-space
    shadow-dirty frame, a ``RenderLoop`` frame) starts with ``host.`` or
    is one of the sixteen ``frame.*`` passes (two of them, the point-light
    cube's ``frame.shadow_cube`` and ``frame.vis_cube``, entered only by a
    scene whose point light casts its shadow)."""
    assert len(profiling.SPANS) == 16
    assert all(n.startswith("frame.") for n in profiling.SPANS)
    session = _Ranges(monkeypatch)
    r = FrameRenderer(scene, _BASE, device="cpu")
    session(r.render)
    t = FrameRenderer(scene, _TSS, device="cpu")
    t.render()
    t.mark_shadows_dirty()
    session(t.render)
    loop = RenderLoop(scene, _TSS, target_fps=0, device="cpu")
    session(loop.render_one)
    loop.drain()
    names = session.names()
    assert {"frame.shade", "frame.tss_bake", "host.shadow_fit"} <= names
    assert all(n.startswith("host.") or n in profiling.SPANS
               for n in names), sorted(names)
    assert len(profiling.frame_trace()) == 1      # the loop's renderer


def test_sync_counter_counts_the_shadow_read(scene, monkeypatch):
    """A shadow-dirty frame makes one host wait (the shadow pass's
    overflow read), a warm frame none; the records carry the count."""
    session = _Ranges(monkeypatch)
    r = FrameRenderer(scene, _TSS, device="cpu")
    r.render()
    n = r.host_syncs
    r.render()
    assert r.host_syncs == n
    r.mark_shadows_dirty()
    r.render()
    assert r.host_syncs == n + 1
    r.mark_shadows_dirty()
    session(lambda: (r.render(), r.render()))
    assert [x["syncs"] for x in profiling.frame_trace()] == [1, 0]
    assert [x["dirty"] for x in profiling.frame_trace()] == [True, False]


def test_two_renderers_do_not_mix_records(scene, monkeypatch):
    session = _Ranges(monkeypatch)
    a = FrameRenderer(scene, _TSS, device="cpu")
    session(a.render)
    assert len(profiling.frame_trace()) == 1
    b = FrameRenderer(scene, _TSS, device="cpu")
    assert profiling.frame_trace() == []
    session(lambda: (a.render(), b.render()))
    recs = profiling.frame_trace()
    assert len(recs) == 1 and recs[0] is b.frame_records[0]
    assert len(a.frame_records) == 2


# --- the benchmark's readers of the records --------------------------------

def _rec(replayed=True, dirty=False, syncs=0, fit=None, **dev):
    device_ms = dict.fromkeys(profiling.STAMPED, 0.0)
    device_ms.update({f"frame.{k}": v for k, v in dev.items()})
    host = {} if fit is None else {"host.shadow_fit": fit}
    return {"replayed": replayed, "dirty": dirty, "host_ms": host,
            "syncs": syncs, "device_ms": device_ms}


def _read(name):
    from portbench import harness

    return harness.load_module("metrics", name).read({})


_READERS = ("shading.replay_ms", "binning.replay_ms", "shadow.replay_ms",
            "shadow.host_fit_ms", "loop.host_syncs_per_frame",
            "raster.replay_ms", "encode.replay_ms")


@pytest.mark.parametrize("name", _READERS)
def test_metric_readers_are_silent_without_records(monkeypatch, name):
    monkeypatch.setattr(profiling, "frame_trace", lambda: [])
    assert _read(name) is None


def test_metric_readers_on_records(monkeypatch):
    unpolled = _rec(dirty=True, syncs=1, fit=9.0)
    unpolled["device_ms"] = None
    recs = [_rec(shade=10.0, peel_shade=2.0, mask=0.5, tss_spec=1.0,
                 setup=1.0, bin_pack=2.0),
            _rec(dirty=True, syncs=1, fit=6.0, shade=12.0, peel_shade=2.0,
                 tss_spec=1.5, setup=2.0, bin_pack=3.0, shadow=15.0,
                 tss_bake=5.0),
            unpolled,
            # eager frames are not the window's
            _rec(replayed=False, dirty=True, syncs=3, fit=50.0, shade=99.0,
                 shadow=99.0)]
    monkeypatch.setattr(profiling, "frame_trace", lambda: recs)
    assert _read("shading.replay_ms") == pytest.approx((13.5 + 15.5) / 2)
    assert _read("binning.replay_ms") == pytest.approx((3.0 + 5.0) / 2)
    assert _read("shadow.replay_ms") == pytest.approx(20.0)
    assert _read("shadow.host_fit_ms") == pytest.approx(7.5)
    assert _read("loop.host_syncs_per_frame") == pytest.approx(2 / 3)
    monkeypatch.setattr(profiling, "frame_trace", lambda: recs[:1])
    assert _read("shadow.replay_ms") is None
    assert _read("shadow.host_fit_ms") is None
    assert _read("loop.host_syncs_per_frame") == 0


def test_raster_and_encode_readers_on_records(monkeypatch):
    unpolled = _rec(merged_raster=9.0)
    unpolled["device_ms"] = None
    recs = [_rec(merged_raster=0.5, peel_raster=0.01, encode=0.1,
                 shade=10.0),
            _rec(dirty=True, raster=0.3, peel_raster=0.2, encode=0.2,
                 shadow=15.0),
            unpolled,
            # eager frames are not the window's
            _rec(replayed=False, raster=50.0, encode=50.0)]
    monkeypatch.setattr(profiling, "frame_trace", lambda: recs)
    assert _read("raster.replay_ms") == pytest.approx((0.51 + 0.5) / 2)
    assert _read("encode.replay_ms") == pytest.approx(0.15)


@pytest.mark.parametrize("name", ["raster.replay_ms", "encode.replay_ms"])
def test_raster_and_encode_readers_are_silent_on_older_records(
        monkeypatch, name):
    """Records of a program that stamped none of the raster and resolve
    regions (their ``device_ms`` lack the keys) read nothing, and raise
    nothing."""
    recs = [_rec(shade=10.0, setup=1.0), _rec(shade=12.0)]
    for r in recs:
        for n in _NEW_REGIONS:
            del r["device_ms"][n]
    monkeypatch.setattr(profiling, "frame_trace", lambda: recs)
    assert _read(name) is None
    assert _read("shading.replay_ms") == pytest.approx(11.0)


# --- on the card ------------------------------------------------------------

@pytest.mark.gpu
def test_replayed_frame_stamps_on_the_card(scene):
    """A replayed texture-space frame: its stamped passes sum to no more
    than its stamped frame span, the shadow-dirty frame's shadow pass and
    bakes are stamped, and the image is byte-equal with and without a
    profiler session open."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stamps are kernels of the graph")
    sc = procedural.sponza_scene(width=256, height=128, n_textures=8,
                                 target_tris=20_000)
    r = FrameRenderer(sc, _TSS.replace(width=256, height=128,
                                       shadow_extent=512))
    for _ in range(4):
        r.render()
        torch.cuda.synchronize()
    plain = r.render()[0].cpu()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]):
        traced = r.render()[0].cpu()
        r.mark_shadows_dirty()
        r.render()
        torch.cuda.synchronize()
    r.render()
    torch.cuda.synchronize()
    r._poll_overflow()
    assert torch.equal(plain, traced)
    warm, dirty = profiling.frame_trace()
    assert warm["replayed"] and dirty["replayed"] and dirty["dirty"]
    assert (warm["syncs"], dirty["syncs"]) == (0, 1)
    # ``frame.peel_raster`` holds no launch here (its two stamps alone):
    # on the card it may read 0 at the clock's resolution
    for rec, regions in ((warm, _REGIONS["tss"] - {"frame.shadow",
                                                   "frame.tss_bake"}),
                         (dirty, _REGIONS["tss"])):
        dev = rec["device_ms"]
        assert {k for k, v in dev.items() if v > 0} - {
            "frame.peel_raster"} == regions - {"frame.peel_raster"}, dev
        own = sum(v for k, v in dev.items()
                  if k not in ("frame", "frame.shadow", "frame.tss_bake"))
        assert own <= dev["frame"], dev
    assert np.isfinite(dirty["host_ms"]["host.shadow_fit"])


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_replayed_supersampled_frame_stamps_the_raster_and_resolve(name):
    """A replayed ``ssaa=2`` frame (512x256 inside): the raster passes
    that launch a kernel and ``frame.encode`` (the box resolve and the
    sRGB encode) read positive device ms, and every stamped region of
    the frame program together is no more than its frame span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stamps are kernels of the graph")
    sc = procedural.sponza_scene(width=256, height=128, n_textures=8,
                                 target_tris=20_000)
    r = FrameRenderer(sc, _CONFIGS[name].replace(width=256, height=128,
                                                 shadow_extent=512, ssaa=2))
    for _ in range(4):
        r.render()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]):
        img = r.render()[0]
        torch.cuda.synchronize()
    r.render()
    torch.cuda.synchronize()
    r._poll_overflow()
    assert img.shape == (128, 256, 4)
    rec, = profiling.frame_trace()
    assert rec["replayed"]
    dev = rec["device_ms"]
    launched = ({"frame.merged_raster", "frame.encode"} if name == "tss"
                else {"frame.raster", "frame.peel_raster", "frame.encode"})
    assert all(dev[n] > 0 for n in launched), dev
    assert all(dev[n] >= 0 for n in _NEW_REGIONS), dev
    own = sum(v for k, v in dev.items()
              if k not in ("frame", "frame.shadow", "frame.tss_bake"))
    assert own <= dev["frame"], dev
