"""Profiling + tracing — the observability subsystem the reference never
built (``todo.md:20`` RenderDoc debug info; SURVEY §5 'tracing: none').

Three tools:
- ``time_frames``: the time of ``fn()`` per call, with CUDA events on the
  card (the device's own clock, from the first queued op to the last) and
  the host clock around a synchronize on the CPU.
- ``trace``: a context manager around ``torch.profiler`` that exports a
  Chrome trace (chrome://tracing, Perfetto) of what runs inside it.
- ``profile_frame``: a ``FrameRenderer``'s shadow pass and frame timed
  apart.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


def _is_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def time_frames(fn, reps: int = 8, warmup: int = 1, device=None) -> dict:
    """Median/min/max time of ``fn()`` in seconds over ``reps`` calls,
    after ``warmup`` calls. On a CUDA ``device`` each call is bracketed by
    CUDA events recorded on the current stream (the host is free while
    the card works; the wait is on the second event alone); elsewhere by
    the host clock."""
    cuda = _is_cuda(device)
    for _ in range(warmup):
        fn()
    if cuda:
        torch.cuda.synchronize(device)
    times = []
    for _ in range(reps):
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return {"median": float(np.median(times)), "min": float(min(times)),
            "max": float(max(times)), "reps": reps}


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Profile the body with ``torch.profiler`` (the card's kernels too on
    a CUDA ``device``) and write ``<log_dir>/trace.json``, a Chrome trace.
    Yields the profiler, whose ``key_averages()`` the caller may read."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if _is_cuda(device):
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if _is_cuda(device):
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def profile_frame(renderer, reps: int = 6) -> dict:
    """Per-pass breakdown for a ``FrameRenderer``: the shadow pass and the
    frame (minus the cached shadow pass) timed apart, at the renderer's
    current config and camera. The renderer's controller does not run
    here; a renderer that has not rendered yet renders once first (the
    texture-space bakes read the shadow maps)."""
    from ..graph import frame as fr

    dev = renderer.device
    if renderer.n_shadows > 0 and renderer._shadow_maps is None:
        renderer.render()
    u = torch.from_numpy(renderer.uniform_for_camera()).to(dev)
    out = {}
    cfg = renderer.config
    if renderer.n_shadows > 0:
        def shadow():
            return fr.render_shadow_pass(
                renderer.scene_dev, u, cfg, renderer.n_shadows,
                renderer.backend, max_pairs=renderer._shadow_budget_val)
        out["shadow_pass"] = time_frames(shadow, reps=reps, device=dev)
        maps = shadow()
    else:
        maps = None

    def frame():
        return fr.render_frame(
            renderer.scene_dev, u, maps, cfg, renderer.n_shadows,
            renderer.backend, renderer._has_translucent,
            renderer._slots_used, shadow_lights=renderer._shadow_lights,
            has_mask=renderer._has_mask,
            alpha_is_factor=renderer._alpha_is_factor)
    out["frame"] = time_frames(frame, reps=reps, device=dev)
    return out
