"""Profiling + tracing — the observability subsystem the reference never
built (``todo.md:20`` RenderDoc debug info; SURVEY §5 'tracing: none').

- ``span(name)``: the port's one way to name a stage. A ``frame.*`` span
  names a pass of the frame (``graph/frame.py``), a ``host.*`` span a
  stage of the host's work around it (``FrameRenderer.render()``, the
  render loop, a capture). While a ``torch.profiler`` session runs it is
  a ``record_function`` range; otherwise it costs a flag check. Inside a
  renderer's programs (a bound ``Stamps`` buffer) the regions of
  ``STAMPED`` also write device clock stamps, which a captured CUDA graph
  keeps as kernels of its own: the device time of each pass of a
  replayed frame.
- ``frame_trace()``: one record per frame that ``FrameRenderer.render()``
  made while a profiler session was active (host ms of each ``host.*``
  span, host syncs, device ms of each stamped region).
- ``trace``: a context manager around ``torch.profiler`` that exports a
  Chrome trace (chrome://tracing, Perfetto) of what runs inside it.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

# the ranges the frame's passes open (``graph/frame.py``); every other
# range the port opens is named ``host.*``
SPANS = ("frame.shadow", "frame.tss_bake", "frame.tss_spec", "frame.setup",
         "frame.bin_pack", "frame.raster", "frame.merged_raster",
         "frame.shade", "frame.mask", "frame.sky", "frame.peel_raster",
         "frame.peel_shade", "frame.overlay", "frame.encode",
         "frame.shadow_cube", "frame.vis_cube")
# the regions whose device time a ``Stamps`` buffer keeps: ``frame``, the
# frame program from its first operation to its last (no range), and the
# spans the shading, binning, shadow, raster and resolve readings add up
# (``frame.encode`` holds the ``ssaa`` box resolve and the sRGB encode;
# ``frame.shadow_cube`` a point light's six faces inside ``frame.shadow``,
# ``frame.vis_cube`` its cube lookup inside the visibility bake, entered
# only by scenes with a point-light shadow)
STAMPED = ("frame", "frame.tss_spec", "frame.setup", "frame.bin_pack",
           "frame.shade", "frame.mask", "frame.peel_shade", "frame.shadow",
           "frame.tss_bake", "frame.merged_raster", "frame.raster",
           "frame.peel_raster", "frame.encode", "frame.shadow_cube",
           "frame.vis_cube")
_SLOT = {n: i for i, n in enumerate(STAMPED)}

_bound = None        # the Stamps of the program being dispatched
_open = None         # the record of the frame being dispatched
_records: list = []  # the records of the most recently built renderer


def _profiling() -> bool:
    return _autograd_profiler._is_profiler_enabled


class Stamps:
    """A renderer's device clock stamps: int64 ``buf`` of ``2 *
    len(STAMPED)`` slots, each region's last entry time, then each
    region's summed duration (ns). The buffer outlives the renderer's
    captured programs, which write it at their addresses: a region's
    entry writes its entry slot, its exit adds the time since then to its
    duration slot (a region entered twice sums), and ``finish()``, the
    frame program's last operation, hands the durations out and clears
    them. On the card a stamp is a one-thread kernel reading
    ``%globaltimer`` (``csrc/raster_tile.cu``), a node of the graph that
    captures it; on the CPU it is ``time.perf_counter_ns()``."""

    def __init__(self, device):
        self.buf = torch.zeros(2 * len(STAMPED), dtype=torch.int64,
                               device=device)
        self._host = self.buf.numpy() if self.buf.device.type == "cpu" \
            else None

    def _stamp(self, name: str, exit_: bool, out=None) -> None:
        i = _SLOT.get(name)
        if i is None:
            return
        if self._host is None:
            from ..raster import cuda_raster

            cuda_raster.stamp(self.buf, i, exit_, out, len(STAMPED))
            return
        n, h = len(STAMPED), self._host
        t = time.perf_counter_ns()
        if exit_:
            h[n + i] += t - h[i]
        else:
            h[i] = t
        if out is not None:
            out.numpy()[...] = h[n:]
            h[n:] = 0

    def enter(self, name: str) -> None:
        self._stamp(name, False)

    def exit(self, name: str) -> None:
        self._stamp(name, True)

    def finish(self) -> torch.Tensor:
        """Close the ``frame`` region; returns the regions' durations (ns,
        int64 [len(STAMPED)]) and clears them, so a frame that renders no
        shadow pass or bake reads 0 there."""
        out = torch.empty(len(STAMPED), dtype=torch.int64,
                          device=self.buf.device)
        self._stamp("frame", True, out)
        return out


@contextlib.contextmanager
def stamping(stamps: Stamps):
    """Bind ``stamps``: the stamped spans entered inside write it."""
    global _bound
    prev, _bound = _bound, stamps
    try:
        yield stamps
    finally:
        _bound = prev


class span:
    """``with span(name):`` names a stage. With a profiler session
    running: a ``record_function`` range (so it shares the profiler's
    clock with the device trace), and a ``host.*`` span adds its host ms
    to the record of the frame being dispatched. With ``Stamps`` bound, a
    region of ``STAMPED`` writes its entry and exit stamps."""

    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self):
        if _profiling():
            self._range = record_function(self.name)
            self._range.__enter__()
            self._t0 = time.perf_counter_ns()
        if _bound is not None:
            _bound.enter(self.name)
        return self

    def __exit__(self, *exc):
        if _bound is not None:
            _bound.exit(self.name)
        if self._range is not None:
            if _open is not None and self.name.startswith("host."):
                ms = _open["host_ms"]
                ms[self.name] = ms.get(self.name, 0.0) + (
                    time.perf_counter_ns() - self._t0) / 1e6
            self._range.__exit__(*exc)
            self._range = None
        return False


def new_frame_trace() -> list:
    """A renderer's list of records, from now on the one ``frame_trace()``
    returns."""
    global _records
    _records = []
    return _records


@contextlib.contextmanager
def frame_record(records: list):
    """The record of one frame, appended to ``records`` while a profiler
    session runs (else None). Nested calls share the outer record: the
    render loop opens it around ``render()`` and its image fetch."""
    global _open
    if _open is not None or not _profiling():
        yield _open
        return
    rec = {"replayed": False, "dirty": False, "host_ms": {}, "syncs": 0,
           "device_ms": None}
    records.append(rec)
    _open = rec
    try:
        yield rec
    finally:
        _open = None


def record_stamps(rec: dict, pass_ns) -> None:
    """Fill a record's device ms from its frame's ``Stamps`` durations."""
    rec["device_ms"] = {n: int(v) / 1e6 for n, v in zip(STAMPED, pass_ns)}


def frame_trace() -> list[dict]:
    """The frames the most recently built ``FrameRenderer`` rendered while
    a ``torch.profiler`` session was active, oldest first, one dict each:
    ``replayed`` (a replay of the captured frame program, else dispatched
    op by op), ``dirty`` (the shadow maps rendered again), ``host_ms`` (ms
    of each ``host.*`` span inside the call and, through a ``RenderLoop``,
    its image fetch), ``syncs`` (host waits on the device the call made),
    ``device_ms`` (ms of each region of ``STAMPED``, 0 where the frame did
    not enter it; None until the frame's counters are polled)."""
    return list(_records)


def _is_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


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
