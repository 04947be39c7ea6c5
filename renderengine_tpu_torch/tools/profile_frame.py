"""Where the time of one frame goes, on the GPU.

    python -m renderengine_tpu_torch.tools.profile_frame \
        [--width 1920] [--height 1080] [--frames 3] [--trace DIR] \
        [--opaque | --tss]

Builds the procedural Sponza (260k triangles, 200 textures) at the given
size with the default config that ``chip_smoke.py`` drives (``--opaque``:
shadows, skybox and translucency off, the first slice's frame; ``--tss``:
the texture-space headline config, ``texture_space`` +
``tss_preshaded_blend`` + ``dither_trilinear`` + ``sky_halfres``),
renders four warm-up frames with a synchronize after each (the first also
renders the cached shadow maps; the overflow poll consumes their counters,
and its first re-tunes recapture the frame there, not in the profiled
window), then runs ``torch.profiler`` twice over ``--frames`` frames and
prints one JSON line with both, labelled:

- ``eager``: the frame dispatched op by op (``FrameRenderer.render_eager``,
  the pass chain the card's graph holds), for the per-layer table: per
  span (``frame.tss_spec``, ``frame.setup``, ``frame.bin_pack``,
  ``frame.raster`` or ``frame.merged_raster``, ``frame.shade``,
  ``frame.mask``, ``frame.sky``, ``frame.peel_raster``,
  ``frame.peel_shade``, ``frame.overlay``, ``frame.encode``, named in
  ``graph/frame.py``, listed in ``utils/profiling.SPANS``) the device ms
  per frame. The ranges fire only while the pass chain is dispatched, so
  a replayed frame has none (its passes' device time is in its clock
  stamps: ``utils/profiling.frame_trace()``);
- ``replayed``: warm ``render()`` calls, each a replay of the captured
  frame program: the frame as it runs (``captures_in_window`` counts the
  recaptures inside it, which should be 0).

Each gives the kernels with the most device time, the wall ms per frame,
the kernel launches per frame and the device busy share (union of kernel
intervals over the window). Last, ``shadow_frame_eager``: one eager
shadow-dirty frame, for the ``frame.shadow`` span (both maps' setup,
binning, K1 and packing) and, with ``--tss``, ``frame.tss_bake`` (the
visibility bake and the static light tables); ``shadow_frame_replayed``:
one shadow-dirty ``render()``, the shadow pass and the bakes as replays of
their captured programs.

``--trace DIR`` also writes the profiler's Chrome trace there. Needs a
CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from ..utils.profiling import SPANS


def _card() -> str:
    res = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return res.stdout.strip()


def _union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _annotation(name: str) -> bool:
    """A range's device-side annotation (a span's), not device work."""
    return name in SPANS or name.startswith("host.")


def profiled(fn, frames: int, trace_dir: str | None) -> dict:
    """``torch.profiler`` over ``frames`` calls of ``fn`` (a frame)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace_dir:
        Path(trace_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(trace_dir) / "frame_trace.json"))
    cuda = torch.autograd.DeviceType.CUDA
    # a span's kernel time from its host-side event (the kernels of its
    # child ops); key_averages() would merge in the span's device-side
    # annotation, which covers the span's whole range of the timeline
    spans = dict.fromkeys(SPANS, 0.0)
    for e in prof.events():
        if e.device_type != cuda and e.name in SPANS:
            spans[e.name] += e.device_time_total / 1e3 / frames
    kernels = [e for e in prof.key_averages()
               if e.device_type == cuda and not _annotation(e.key)]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    top = [{"name": e.key[:90], "ms_per_frame":
            e.self_device_time_total / 1e3 / frames,
            "calls_per_frame": e.count / frames} for e in kernels[:12]]
    ivals = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == cuda and not _annotation(e.name)]
    busy_ms = _union_us(ivals) / 1e3
    return {"wall_ms_per_frame": wall_ms / frames,
            "device_busy_ms_per_frame": busy_ms / frames,
            "device_busy_share": busy_ms / wall_ms if wall_ms else 0.0,
            "kernel_launches_per_frame": sum(e.count for e in kernels)
            / frames,
            "span_device_ms_per_frame": spans, "top_kernels": top}


def eager_frame(renderer, view_props=None, dirty: bool = False):
    """One ``renderer.render(view_props)`` dispatched op by op, as an
    exposure-change frame or, with ``dirty``, a shadow-dirty one: the
    uniform's upload (after the shadow refit with ``dirty``), the shadow
    pass and its overflow read, the texture-space bakes (the visibility
    with ``dirty``; the tables) and the frame (``render_eager``). It
    writes the uniform and the tables as ``render()`` does at that
    exposure, and leaves the shadow pack and the dirty flag as they
    are."""
    from ..graph import uniforms
    from ..graph.frame import bake_tss, render_shadow_pass, tss_bakes
    from ..shading import fitting

    r = renderer
    dirty = dirty and r.n_shadows > 0
    params = r.params_for_camera(view_props)
    maps = r._shadow_maps
    if dirty:
        params["shadow_viewproj"] = fitting.shadow_transforms_for_scene(
            r.scene_host)
    uniforms.upload(r._u, uniforms.pack_params(params, r.n_shadows))
    if dirty:
        maps, sov = render_shadow_pass(
            r.scene_dev, r._u, r.config, r.n_shadows, r.backend,
            max_pairs=r._shadow_budget_val, return_overflow=True,
            cube_bases=r._cube_bases)
        int(sov)
    if r.config.texture_space:
        bake_tss(tss_bakes(r.scene_dev, r._u, maps, r.n_shadows,
                           r._shadow_lights, r.config, dirty))
    return r.render_eager()


def replayed_dirty_frame(renderer):
    """One shadow-dirty ``render()``: the shadow, bake and frame programs
    replayed."""
    def run():
        renderer.mark_shadows_dirty()
        renderer.render()
    return run


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--trace", default=None,
                    help="directory for the Chrome trace")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--opaque", action="store_true",
                      help="shadows, skybox and translucency off")
    mode.add_argument("--tss", action="store_true",
                      help="the texture-space headline config")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_frame: needs a CUDA card", file=sys.stderr)
        sys.exit(2)

    from ..core.config import RenderConfig
    from ..graph.frame import FrameRenderer
    from ..scene import procedural

    scene = procedural.sponza_scene(width=args.width, height=args.height)
    cfg = RenderConfig(width=args.width, height=args.height)
    if args.opaque:
        cfg = cfg.replace(shadows=False, skybox=False, translucency=False)
    if args.tss:
        cfg = cfg.replace(debug_views=False, texture_space=True,
                          tss_preshaded_blend=True, dither_trilinear=True,
                          sky_halfres=True)
    renderer = FrameRenderer(scene, cfg)
    for _ in range(4):
        renderer.render()
        torch.cuda.synchronize()
    caps = renderer.program_counts["frame_captures"]
    out = {"card": _card(), "width": args.width, "height": args.height,
           "frames": args.frames, "opaque": args.opaque, "tss": args.tss,
           "eager": profiled(renderer.render_eager, args.frames, args.trace),
           "replayed": profiled(renderer.render, args.frames, None),
           "captures_in_window":
               renderer.program_counts["frame_captures"] - caps,
           "shadow_frame_eager": profiled(
               lambda: eager_frame(renderer, dirty=True), 1, None),
           "shadow_frame_replayed": profiled(replayed_dirty_frame(renderer),
                                             1, None)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
