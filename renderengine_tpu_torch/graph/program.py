"""Captured CUDA graphs of the frame's programs.

The JAX package turns each frame into one compiled program
(``FrameRenderer._rebuild_frame_fn``: ``jax.jit`` of ``render_frame`` with
the config, budgets and static flags bound; ``_rebuild_shadow_fn`` for the
shadow pass), so the host launches one prepared program a frame. The
counterpart here is a CUDA graph: the pass chain is captured once per
config and budget, and every warm frame replays it. Its inputs are tensors
that outlive the graph (the scene, the uniform, the shadow pack), read at
their addresses; its outputs are tensors of the graph's private memory
pool that each replay overwrites. The texture-space bakes (the JAX
``_vis_fn`` and ``_ld_fn``) are programs too, which write into the
tables the frame reads and return nothing.

A program may hold NCCL collectives (the sharded renderer's band frame
and shadow pass): the process group runs each on its own stream, joined
to the capture stream by events, which the capture records as the
graph's fork and join; the warm-up's collectives run eagerly first, so
the communicator exists before the capture. Every rank must capture and
replay the same programs in the same order.
"""

from __future__ import annotations

import time

import torch

from ..raster import cuda_raster
from ..utils.profiling import span


class CapturedProgram:
    """``fn()`` captured into one CUDA graph on ``stream``.

    The capture: ``fn`` runs once eagerly on ``stream`` (the warm-up, whose
    launches are real and counted: it sizes the raster workspace on that
    stream and makes any lazy library state), then runs again under
    capture into a graph with its own memory pool, which is then
    instantiated. ``fn`` must read no tensor data on the host and size
    nothing from it; a capture that fails raises, and nothing falls back.
    The kernel launches the capture recorded are taken out of
    ``cuda_raster``'s counters (a capture launches nothing) and kept in
    ``launches``; each ``replay()`` adds them back.

    Measured on the way, on the host clock: ``warmup_ms``, ``capture_ms``
    (the captured calls up to the end of capture), ``instantiate_ms``, and
    ``pool_bytes`` (the device memory the graph's pool reserved)."""

    def __init__(self, fn, device, stream, key=None):
        device = torch.device(device)
        self.key = key
        cur = torch.cuda.current_stream(device)
        # after every frame queued so far: the workspace and the inputs are
        # theirs until then
        stream.wait_stream(cur)
        t0 = time.perf_counter()
        with torch.cuda.device(device), torch.cuda.stream(stream):
            fn()
        self.warmup_ms = (time.perf_counter() - t0) * 1e3
        snap = cuda_raster.count_snapshot()
        reserved = torch.cuda.memory_reserved(device)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with torch.cuda.device(device), torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = fn()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass        # the capture was already invalidated
                cuda_raster.add_counts(cuda_raster.counts_since(snap), -1)
                raise
            graph.capture_end()
        t1 = time.perf_counter()
        graph.instantiate()
        self.capture_ms = (t1 - t0) * 1e3
        self.instantiate_ms = (time.perf_counter() - t1) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        cur.wait_stream(stream)
        self.launches = cuda_raster.counts_since(snap)
        cuda_raster.add_counts(self.launches, -1)
        # the graph's launches keep the workspace's pointers
        self.workspace = cuda_raster.workspace_tensors(device)
        self.graph, self.outputs = graph, out
        self.replays = 0

    def replay(self):
        """Run the graph on the current stream; returns ``fn``'s outputs,
        which this replay overwrites (clone what must outlive the next)."""
        self.graph.replay()
        cuda_raster.add_counts(self.launches)
        self.replays += 1
        return self.outputs

    def stats(self) -> dict:
        """The capture's measurements and the launches one replay makes
        (K1/K2 by variant)."""
        return {"warmup_ms": self.warmup_ms, "capture_ms": self.capture_ms,
                "instantiate_ms": self.instantiate_ms,
                "pool_bytes": self.pool_bytes, "replays": self.replays,
                "launches": {str(k): n for k, n in self.launches[1].items()}}


class Programs:
    """A renderer's captured programs, by name. ``get`` captures one when
    first asked and again when its key (what it binds: config fields,
    budgets) changes, as the JAX package re-jits a function on new static
    arguments; the old graph and its pool are released first, and frames
    it already queued stay valid (the capture stream runs them first).
    All of them capture on one stream, made at the first capture.
    ``counts`` holds each program's captures and replays."""

    def __init__(self, device, names):
        self.device = torch.device(device)
        self.stream = None
        self.progs = dict.fromkeys(names)
        self.counts = {f"{n}_{what}": 0 for n in names
                       for what in ("captures", "replays")}

    def get(self, name: str, key, fn) -> CapturedProgram:
        """The program ``name`` at ``key``, capturing ``fn`` if it has
        none or another key."""
        prog = self.progs[name]
        if prog is None or prog.key != key:
            if self.stream is None:
                self.stream = torch.cuda.Stream(self.device)
            self.progs[name] = None
            with span("host.capture"):
                self.progs[name] = prog = CapturedProgram(
                    fn, self.device, self.stream, key=key)
            self.counts[f"{name}_captures"] += 1
        return prog

    def replay(self, name: str):
        """Replay the program ``name`` (see ``CapturedProgram.replay``)."""
        self.counts[f"{name}_replays"] += 1
        return self.progs[name].replay()

    def stats(self) -> dict:
        """``counts`` and each captured program's ``stats()``."""
        out = dict(self.counts)
        out.update((n, p.stats()) for n, p in self.progs.items()
                   if p is not None)
        return out


__all__ = ["CapturedProgram", "Programs"]
