"""The traced readings of a ``--trace 1`` run, after its window:

- ``torch.profiler`` over about ``window_s`` more seconds of the cell's
  own traffic through ``render_one()`` (replayed frames): device busy
  time (the union of every device operation's interval), kernel records
  per frame, the raster kernels' records by variant, the device
  operations with most time and the idle gaps by what the host was doing
  (the innermost ``host.*`` span the harness opened around the call);
- the program's own spans (``record_function`` ranges named ``frame.*``
  in ``graph/frame.py``), which fire only while the pass chain is
  dispatched op by op: ``eager`` frames at poses of the window (with
  shadows dirty each frame, ``tools.profile_frame.eager_frame``'s
  shadow-dirty frame) read their device time.
"""

from __future__ import annotations

import math
import time

from . import stats

SPANS = ("frame.shadow", "frame.tss_bake", "frame.tss_spec", "frame.setup",
         "frame.bin_pack", "frame.raster", "frame.merged_raster",
         "frame.shade", "frame.mask", "frame.sky", "frame.peel_raster",
         "frame.peel_shade", "frame.overlay", "frame.encode")
TOP = 10


def _device_events(prof):
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.events():
        if e.device_type != cuda:
            continue
        # user annotations (the spans' device-side ranges) are no work
        if e.name in SPANS or e.name.startswith("host."):
            continue
        out.append(e)
    return out


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "Memory"))


def _gap_labels(prof, gaps):
    """For each idle gap (a, b), what the host was doing: the innermost
    ``host.*`` span (opened by the harness around the loop's and the
    renderer's calls) covering its middle, else ``"between calls"``."""
    import bisect

    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type != cuda and e.name.startswith("host."))
    starts = [h[0] for h in spans]
    longest = max((h[1] - h[0] for h in spans), default=0.0)
    labels = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        lo = bisect.bisect_left(starts, mid - longest)
        hi = bisect.bisect_right(starts, mid)
        inner = [h for h in spans[lo:hi] if h[1] >= mid]
        labels.append(min(inner, key=lambda h: h[1] - h[0])[2] if inner
                      else "between calls")
    return labels


def profile_replayed(cell, window_s: float, min_frames: int) -> dict:
    """The profiled window: the cell's traffic through ``render_one()``
    for about ``window_s`` seconds at the window's rate."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from renderengine_tpu_torch.raster import cuda_raster

    win = cell.last_window
    frame_s = win["wall_s"] / max(1, win["presented"])
    n = max(min_frames, math.ceil(window_s / frame_s))
    first = cell.rec.i
    cell.sync()
    snap = cuda_raster.count_snapshot()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            cell.loop.render_one()
        cell.loop.drain()
        cell.sync()
        t1 = time.perf_counter()
    launched = cuda_raster.counts_since(snap)
    dev = _device_events(prof)
    ivals = [(e.time_range.start, e.time_range.end) for e in dev]
    busy_us = stats.union_length(ivals)
    kernels = [e for e in dev if _is_kernel(e.name)]
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e6
    merged = stats.merged(ivals)
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
    idle: dict[str, float] = {}
    for lab, (a, b) in zip(_gap_labels(prof, gaps), gaps):
        idle[lab] = idle.get(lab, 0.0) + (b - a) / 1e6
    raster = [(e.name, (e.time_range.end - e.time_range.start) / 1e6)
              for e in kernels
              if "raster_tile_kernel" in e.name
              or "merged_tile_kernel" in e.name]
    return {
        "frames": n, "poses": list(range(first, first + n)),
        "window_s": t1 - t0, "busy_s": busy_us / 1e6,
        "kernels": len(kernels), "raster": raster,
        "launched": {str(k): v for k, v in launched[1].items()},
        "breakdown": {
            "device_ops": [[k[:120], v] for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:TOP]],
            "idle_gaps": [[k[:120], v] for k, v in sorted(
                idle.items(), key=lambda kv: -kv[1])[:TOP]]},
    }


def eager_spans(cell, frames: int) -> dict:
    """Device ms a frame of each ``frame.*`` span over ``frames`` eager
    frames at poses spread over the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from renderengine_tpu_torch.tools.profile_frame import eager_frame

    cuda = torch.autograd.DeviceType.CUDA
    win = cell.last_window
    n_win = max(1, win["presented"])
    spans = dict.fromkeys(SPANS, 0.0)
    r = cell.r
    for j in range(frames):
        i = win["first_pose"] + j * n_win // frames
        cell.sched.apply(cell.cam, cell.eye0, cell.look0, i)
        vp = cell.ViewProperties.from_camera(cell.cam)
        dirty = cell.sched.dirty(i)
        if not dirty:
            # the uniform and the budgets of a frame at this pose
            r.render(vp)
        cell.sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if dirty:
                eager_frame(r, vp, dirty=True)
            else:
                r.render_eager()
            cell.sync()
        for e in prof.events():
            if e.device_type != cuda and e.name in SPANS:
                spans[e.name] += e.device_time_total / 1e3 / frames
    return spans


def read(cell, window_s: float, min_frames: int, eager: int) -> dict:
    out = profile_replayed(cell, window_s, min_frames)
    out["spans"] = eager_spans(cell, eager)
    return out
