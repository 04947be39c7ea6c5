"""One run of one benchmark cell of ``renderengine_tpu_torch``: set-up,
the measured window through ``RenderLoop.render_one()``, the traced
readings with ``--trace 1``, and the comparison with the plain reference
that decides ``correct``.

Everything that belongs to a configuration, a traffic mix, a per-layer
metric or a kernel lives in files found by name: ``configs/<config>.json``,
``traffic/<traffic>.json`` (read by ``schedule.py``),
``metrics/<metric>.py`` and ``kernels/<kernel>.py``; ``BENCHMARK.json``
names them.
"""

from __future__ import annotations

import gc
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from . import checks, schedule, stats

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".portbench_cache"
# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "renderengine_tpu")
TRACE_WINDOW_S = 1.0      # the profiled window of replayed frames
TRACE_MIN_FRAMES = 3
EAGER_FRAMES = 2          # eager frames read for the program's spans
ROOFLINE_POSES = 3        # poses of the profiled window counted for bounds


class CellError(RuntimeError):
    """The run cannot produce a result (no card, unknown cell, a module
    that may not be loaded)."""


def set_cache_env() -> None:
    """Fixed cache directories inside the checkout, set before torch is
    imported; the port's own kernel build goes to its ``build/``."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["RENDERENGINE_TORCH_CACHE_DIR"] = str(CACHE / "engine")
    # every run sizes its budgets with the renderer's estimators and its
    # controller: a record of an earlier run would change the set-up
    os.environ["RENDERENGINE_TUNED_CACHE"] = "0"


def load_cell(workload: str) -> dict:
    """The cell's entry of ``BENCHMARK.json`` with its configuration file
    and traffic parameters, found by name."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise CellError(f"unknown workload {workload!r}; one of "
                        f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[cell["config"]]
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return {"bench": bench, "cell": cell, "config": config,
            "traffic": traffic}


def cell_metrics(bench: dict, workload: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics the cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def load_file(path: Path, module_name: str):
    """The module of one ``.py`` file, imported under ``module_name``."""
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_module(directory: str, name: str):
    """``<directory>/<name>.py`` under the benchmark, by file name."""
    return load_file(HERE / directory / f"{name}.py",
                     f"portbench.{directory}.{name.replace('.', '_')}")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is forbidden, compared
    whole."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` reports it: the peaks of
    the rooflines hold at 700 W."""
    try:
        res = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu="
                              "power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return res.stdout.strip() or None


def render_config(torch_cfg_cls, raster_cls, fields: dict):
    """A ``RenderConfig`` of either package from the config file's
    fields."""
    fields = dict(fields)
    raster = raster_cls(**fields.pop("raster", {}))
    return torch_cfg_cls(**fields, raster=raster)


def scene_fingerprint(scene, eye0) -> str:
    """Digest of a host scene's inputs (vertices, indices, texture
    images, cubemap, the light and material tables, the shadow-map count
    and each light's shadow map, the starting eye ``eye0``), to hold the
    two generators' scenes equal."""
    h = hashlib.sha1()

    def put(a):
        h.update(np.ascontiguousarray(a).tobytes())

    for a in scene.meshes.build_arrays():
        put(a)
    for t in scene.textures._textures:
        put(t.image)
    put(scene.textures.cubemap)
    for table in (scene.lights.build_arrays(),
                  scene.materials.build_arrays()):
        for k in sorted(table):
            h.update(k.encode())
            put(table[k])
    put(np.array([scene.n_shadow_maps]
                 + [lt.shadow_index for lt in scene.lights.lights], np.int64))
    put(np.asarray(eye0, np.float32))
    return h.hexdigest()


class Recorder:
    """The window's host-side record, fed by the render loop's callbacks:
    each frame's pose hand-off, host ms of its ``render()`` call, its
    counters (device tensors, read after the window) and its
    presentation time; and a seeded reservoir of ``keep`` presented
    frames for the comparison, by the window's frame index."""

    def __init__(self, keep: int, seed: int):
        self.on = False
        self.i = 0                   # the schedule's pose index
        self.first_pose = 0          # the pose of the window's first frame
        self.t_call, self.t_present, self.render_ms = [], [], []
        self.stats = []
        self.keep = keep
        self.kept: dict[int, np.ndarray] = {}
        self._rng = np.random.default_rng([seed % (1 << 64), 1])

    def start(self) -> None:
        """The window opens: the poses go on from where the settling
        left them."""
        self.on = True
        self.first_pose = self.i

    def presented(self, frame: np.ndarray) -> None:
        if not self.on:
            return
        k = len(self.t_present)
        self.t_present.append(time.perf_counter())
        # reservoir sampling: each presented frame is kept with the same
        # chance; keeping the array keeps its pinned buffer, no copy
        if k < self.keep:
            self.kept[k] = frame
        else:
            j = int(self._rng.integers(k + 1))
            if j < self.keep:
                victim = sorted(self.kept)[j]
                del self.kept[victim]
                self.kept[k] = frame


class Cell:
    """The system under test for one cell: the scene, the render loop
    over the port's renderer, the schedule and the record."""

    def __init__(self, spec: dict, seed: int, device, keep: int,
                 scene_overrides: dict | None = None,
                 config_overrides: dict | None = None, fault=None):
        import torch

        from renderengine_tpu_torch.core.config import (RasterConfig,
                                                        RenderConfig)
        from renderengine_tpu_torch.graph.render_loop import RenderLoop
        from renderengine_tpu_torch.scene import procedural
        from renderengine_tpu_torch.scene.camera import ViewProperties

        self.torch = torch
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.ViewProperties = ViewProperties
        scene_kw = dict(spec["config"]["scene"])
        builder = scene_kw.pop("builder")
        scene_kw.update(scene_overrides or {})
        self.scene_kw = scene_kw
        self.builder = builder
        build = getattr(procedural, builder, None)
        if not callable(build):
            raise CellError(f"no scene builder {builder!r} in the port's "
                            f"scene/procedural.py")
        self.scene = build(seed=seed, **scene_kw)
        cfg_fields = dict(spec["config"]["render_config"])
        cfg_fields.update(config_overrides or {})
        self.cfg_fields = cfg_fields
        cfg = render_config(RenderConfig, RasterConfig, cfg_fields)
        self.sched = schedule.Schedule(spec["traffic"])
        # a traffic file may state its own settling, else the config's
        self.settle_frames = int(spec["traffic"].get(
            "settle_frames", spec["config"]["settle_frames"]))
        self.cam = self.scene.camera
        self.eye0 = np.asarray(self.cam.eye, np.float32).copy()
        self.look0 = np.asarray(self.cam.look_at, np.float32).copy()
        self.rec = Recorder(keep, seed)
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        self.loop = RenderLoop(self.scene, cfg, target_fps=0,
                               view_props_fn=self._view_props,
                               on_present=self.rec.presented,
                               device=self.device)
        self.r = self.loop.renderer
        if fault is not None:
            # beneath the instrumentation: the run sees what it produces
            fault(self)
        self._instrument()

    # -- the callbacks the loop drives ------------------------------------
    def _view_props(self):
        """The host call that hands a frame its pose."""
        rec = self.rec
        if rec.on:
            rec.t_call.append(time.perf_counter())
        self.sched.apply(self.cam, self.eye0, self.look0, rec.i)
        if self.sched.dirty(rec.i):
            self.r.mark_shadows_dirty()
        rec.i += 1
        return self.ViewProperties.from_camera(self.cam)

    def _instrument(self) -> None:
        """Wrap the renderer's ``render`` (host ms, the frame's counters
        and config) and label the controller's host work for the trace."""
        from torch.profiler import record_function

        r, rec = self.r, self.rec
        render = r.render

        def timed_render(view_props=None):
            with record_function("host.render"):
                t0 = time.perf_counter()
                img, st = render(view_props)
                t1 = time.perf_counter()
            if rec.on:
                rec.render_ms.append((t1 - t0) * 1e3)
                rec.stats.append(st)
            return img, st

        r.render = timed_render
        for name in ("_poll_overflow", "uniform_for_camera",
                     "_render_shadows"):
            fn = getattr(r, name)
            setattr(r, name, _labelled(f"host.{name.lstrip('_')}", fn))
        present = self.loop._present_oldest
        self.loop._present_oldest = _labelled("host.present", present)

    # -- phases ------------------------------------------------------------
    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def captures(self) -> int:
        return self.r.program_counts.get("frame_captures", 0)

    def first_frame(self) -> None:
        """The first frame at the scene's own camera: the shadow maps are
        fitted there, as the texture-space charts were at init."""
        self.r.render()
        self.sync()

    def settle(self, frames: int | None = None) -> dict:
        """A fixed amount of the cell's own traffic before the window:
        poses ``0`` to ``frames - 1`` (the configuration's
        ``settle_frames``, long enough for its controller to reach the
        budgets it keeps on this traffic; fewer in tests), then the last
        counters taken in. The count is the same whatever the program's
        speed."""
        r = self.r
        frames = self.settle_frames if frames is None else frames
        caps0, cfg0 = self.captures(), r.config
        changes, last_change = 0, -1
        for k in range(frames):
            caps, cfg = self.captures(), r.config
            self.loop.render_one()
            if self.captures() != caps or r.config is not cfg:
                changes, last_change = changes + 1, k
        self.loop.drain()
        self.sync()
        if r._react_overflow:
            # the poll takes a frame's counters in at a later render():
            # take the last ones in now
            r._poll_overflow()
        return {"frames": frames, "captures": self.captures() - caps0,
                "config_changed": r.config != cfg0, "changes": changes,
                "last_change_frame": last_change}

    def window(self, seconds: float) -> dict:
        """The measured window: ``render_one()`` unpaced until
        ``seconds`` have passed, then every frame in flight presented."""
        rec = self.rec
        self.sync()
        caps0 = self.captures()
        rec.start()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            self.loop.render_one()
        self.loop.drain()
        self.sync()
        t1 = time.perf_counter()
        rec.on = False
        self.last_window = {"t0": t0, "wall_s": t1 - t0,
                            "first_pose": rec.first_pose,
                            "dispatched": len(rec.t_call),
                            "presented": len(rec.t_present),
                            "recaptures": self.captures() - caps0}
        return self.last_window

    def overflow_frames(self) -> tuple[np.ndarray, int, dict]:
        """Which frames of the window dropped work by their counters, read
        with one copy; the count of frames that dropped work (the shadow
        pass's overflow counts once); and the counters' totals."""
        torch = self.torch
        n = len(self.rec.stats)
        keys = sorted(k for k in self.rec.stats[0] if "overflow" in k) \
            if n else []
        if not keys:
            return np.zeros(n, bool), int(bool(self.r.shadow_overflow)), {}
        rows = torch.stack([torch.stack([st[k].reshape(()).to(torch.int64)
                                         for k in keys])
                            for st in self.rec.stats]).cpu().numpy()
        bad = (rows != 0).any(1)
        totals = {k: int(v) for k, v in zip(keys, rows.sum(0))}
        totals["shadow_overflow"] = int(self.r.shadow_overflow)
        return bad, int(bad.sum()) + int(bool(self.r.shadow_overflow)), \
            totals

    def free(self) -> None:
        """Release the port's renderer and its device memory."""
        self.loop.drain()
        del self.loop, self.r
        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()


def _labelled(label: str, fn):
    from torch.profiler import record_function

    def call(*a, **kw):
        with record_function(label):
            return fn(*a, **kw)
    return call


def run(workload: str, seed: int, seconds: float, trace: bool,
        device=None, require_card: bool = True, control: bool = False,
        scene_overrides: dict | None = None,
        config_overrides: dict | None = None, t_process: float | None = None,
        fault=None, settle_frames: int | None = None) -> dict:
    """One run; returns the result line's object (and ``checks``).
    ``require_card=False`` and ``device`` let the tests drive a run on the
    CPU; ``fault(cell)`` plants a fault in the timed path (tests);
    ``control`` also reads the control's numbers at the compared
    frames; ``settle_frames`` shortens the settling (tests)."""
    t_process = time.perf_counter() if t_process is None else t_process
    spec = load_cell(workload)
    cell_spec = spec["cell"]
    import torch

    if require_card:
        if not torch.cuda.is_available():
            raise CellError("no CUDA device: the benchmark runs only on the "
                            "card")
        if torch.cuda.device_count() < int(cell_spec["chips"]):
            raise CellError(f"the cell needs {cell_spec['chips']} cards, "
                            f"{torch.cuda.device_count()} found")
    device = torch.device(device or "cuda")
    # the reference's scene builder is found now, not after the window
    checks.reference_builder(spec["config"]["scene"]["builder"])
    # float32 products stay float32 (the reference's too)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = Cell(spec, seed, device, checks.FRAMES_KEPT, scene_overrides,
                config_overrides, fault)
    cell.first_frame()
    settle = cell.settle(settle_frames)
    win = cell.window(seconds)
    setup_s = win["t0"] - t_process
    peak = (torch.cuda.max_memory_allocated(device) if cell.cuda else 0)
    bad, bad_frames, counters = cell.overflow_frames()
    rec = cell.rec
    unpresented = win["dispatched"] - win["presented"]
    e2e = {
        "frame_ms": stats.rate_ms(win["wall_s"], win["presented"]),
        "frame_latency_p95_ms": stats.p95(
            [(p - c) * 1e3 for c, p in zip(rec.t_call, rec.t_present)]),
        "peak_mem_gib": peak / 2**30,
        "setup_s": setup_s,
    }
    print(f"# {workload} seed {seed}: set-up {setup_s:.3f} s, settle "
          f"{settle}, window {win['presented']} frames in "
          f"{win['wall_s']:.3f} s, recaptures {win['recaptures']}, "
          f"counters {counters}", file=sys.stderr, flush=True)
    readings = {"window": win, "render_ms": rec.render_ms,
                "settle": settle}
    trace_out = None
    if trace:
        from . import trace as tr
        trace_out = tr.read(cell, TRACE_WINDOW_S, TRACE_MIN_FRAMES,
                            EAGER_FRAMES)
        readings["trace"] = trace_out
        print(f"# traced {trace_out['frames']} frames in "
              f"{trace_out['window_s']:.4f} s: raster launches "
              f"{trace_out['launched']}, profiler records of them "
              f"{len(trace_out['raster'])}", file=sys.stderr, flush=True)
    fingerprint = scene_fingerprint(cell.scene, cell.eye0)
    # the compared frames: of the kept ones, those whose counters report
    # no dropped work (the others count in ``failed``), in a seeded order
    clean = [k for k in sorted(rec.kept) if not bad[k]]
    pick = np.random.default_rng([seed % (1 << 64), 2]).permutation(
        len(clean))[:checks.FRAMES_COMPARED]
    kept = {win["first_pose"] + clean[j]: rec.kept[clean[j]]
            for j in sorted(pick)}
    profiled_poses = trace_out["poses"] if trace_out else []
    sched, scene_kw, builder = cell.sched, cell.scene_kw, cell.builder
    cfg_fields = cell.cfg_fields
    cell.free()
    del cell
    verdict = checks.compare(
        sched=sched, seed=seed, builder=builder, scene_kw=scene_kw,
        cfg_fields=cfg_fields, kept=kept, device=device,
        fingerprint=fingerprint,
        overflow_share=bad_frames / max(1, win["presented"]),
        unpresented=unpresented, control=control,
        count_poses=profiled_poses[:: max(1, len(profiled_poses)
                                          // ROOFLINE_POSES)]
        [:ROOFLINE_POSES] if trace else [])
    if trace:
        readings["passes"] = verdict.pop("pass_counts")
    bench = spec["bench"]
    if trace:
        metrics = {}
        for m in cell_metrics(bench, workload, "per_layer"):
            v = load_module("metrics", m["name"]).read(readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(bench, workload, "end_to_end")}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak),
           "power_limit": power_limit() if require_card else None}
    out = {"correct": verdict["correct"], "attempted": win["dispatched"],
           "failed": bad_frames + unpresented, "metrics": metrics,
           "device": dev}
    if trace:
        dev["busy_s"] = trace_out["busy_s"]
        dev["window_s"] = trace_out["window_s"]
        out["breakdown"] = trace_out["breakdown"]
    if control:
        out["control"] = verdict["control"]
    out["checks"] = verdict["checks"]
    return out


def main(argv=None, t_process: float | None = None) -> int:
    import argparse

    t_process = time.perf_counter() if t_process is None else t_process
    ap = argparse.ArgumentParser(description="One run of one benchmark "
                                 "cell (see portbench/README.md).")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also read the control's numbers (bfloat16 "
                    "reference) at the compared frames")
    args = ap.parse_args(argv)
    set_cache_env()
    try:
        out = run(args.workload, args.seed, args.seconds, bool(args.trace),
                  control=bool(args.control), t_process=t_process)
    except CellError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules that may not be loaded are: {bad}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
