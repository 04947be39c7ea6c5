"""The frame driver.

Reference: ``Source/VkRHI/RHI/RenderLoop.{h,cpp}`` — an abstract run loop:
~60 FPS pacing by yield-spin (``RenderLoop.h:51``), 2 frames in flight
(``constants.h:7``), acquire/record/submit/present, resize-triggered
swapchain recreation (``RenderLoop.cpp:150-171``).

GPU mapping:
- "command recording + submit" = ``FrameRenderer.render()``, which queues
  the frame's work on the card and returns before the card finishes (the
  fence-pipelined submit).
- frames in flight = a bounded queue of frames whose image copy to the
  host has been started (``non_blocking=True`` into pinned memory) with an
  event recorded after it; once the window is full the oldest frame is
  presented after waiting on its event alone, never on the whole device.
- "present" = a host callback receiving the RGBA8 numpy frame.
- resize = a new ``FrameRenderer`` at the new extent, as the reference
  rebuilds its swapchain and pipelines per extent.
"""

from __future__ import annotations

import time
from collections import deque

import torch

from ..core.config import RenderConfig
from ..device import resolve_device
from ..utils import profiling
from ..utils.profiling import span
from .frame import FrameRenderer

MAX_FRAMES_IN_FLIGHT = 2  # reference constants.h:7


class RenderLoop:
    """Concrete driver: subclass or pass callbacks.

    on_update(dt_s) -> bool    host-side per-frame update (camera etc.);
                               return False to stop the loop.
    on_present(frame: np.ndarray) -> None   receives the RGBA8 frames.

    ``device``: ``cuda`` unless the caller passes one.
    """

    def __init__(self, scene_host, config: RenderConfig,
                 on_update=None, on_present=None, target_fps: float = 60.0,
                 backend: str | None = None, view_props_fn=None,
                 device=None):
        self.scene_host = scene_host
        self.config = config
        self.device = resolve_device(device)
        self.renderer = FrameRenderer(scene_host, config, device=self.device,
                                      backend=backend)
        self.on_update = on_update
        self.on_present = on_present
        self.view_props_fn = view_props_fn  # () -> ViewProperties | None
        self.target_fps = target_fps
        self._inflight: deque = deque()
        self.frame_index = 0
        self.frame_times: deque = deque(maxlen=120)

    def resize(self, width: int, height: int) -> None:
        """Swapchain-recreation analog: a new renderer at the new extent."""
        self.drain()
        self.config = self.config.replace(width=width, height=height)
        self.scene_host.camera.set_image_extent(width, height)
        self.renderer = FrameRenderer(self.scene_host, self.config,
                                      device=self.device,
                                      backend=self.renderer.backend)

    @staticmethod
    def _start_fetch(img: torch.Tensor):
        """A frame in flight: (image, host copy, event). On the card the
        copy into pinned memory is queued on the current stream and the
        event recorded after it; on the CPU the image is the host copy."""
        if img.device.type != "cuda":
            return img, img, None
        with span("host.fetch"):
            host = torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
            host.copy_(img, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(img.device))
        return img, host, ev

    def _present_oldest(self) -> None:
        _, host, ev = self._inflight.popleft()
        if ev is not None:
            ev.synchronize()      # this frame's copy alone, not the device
        if self.on_present:
            # the array's base holds the pinned tensor: no copy, and the
            # memory stays the frame's while the caller keeps it
            self.on_present(host.numpy())

    def render_one(self):
        """Dispatch one frame; present the oldest once the in-flight
        window is over full. Returns the dispatched device image."""
        vp = self.view_props_fn() if self.view_props_fn else None
        # under torch.profiler one record holds the call and the fetch
        with profiling.frame_record(self.renderer.frame_records):
            img, _ = self.renderer.render(vp)
            self._inflight.append(self._start_fetch(img))
        if len(self._inflight) > MAX_FRAMES_IN_FLIGHT:
            self._present_oldest()
        self.frame_index += 1
        return img

    def drain(self) -> None:
        """Fence-wait analog: present everything in flight."""
        while self._inflight:
            self._present_oldest()

    def run(self, max_frames: int | None = None) -> None:
        """The Run() loop (``RenderLoop.cpp:52-67``): update -> render,
        paced to ``target_fps`` by sleep-yield."""
        period = 1.0 / self.target_fps if self.target_fps > 0 else 0.0
        last = time.perf_counter()
        while max_frames is None or self.frame_index < max_frames:
            now = time.perf_counter()
            dt = now - last
            if period and dt < period:
                time.sleep(period - dt)
                continue
            last = now
            self.frame_times.append(dt)
            if self.on_update is not None and self.on_update(dt) is False:
                break
            self.render_one()
        self.drain()

    def fps(self) -> float:
        if not self.frame_times:
            return 0.0
        return len(self.frame_times) / max(sum(self.frame_times), 1e-9)
