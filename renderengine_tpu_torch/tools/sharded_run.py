"""Run the sharded renderer on a process group: the launcher that spawns
one process a rank and joins them, and the per-rank entry it spawns.

    python -m renderengine_tpu_torch.tools.sharded_run JOB RANK

``launch`` writes JOB (a pickle): the process group (``dist_backend``,
``world``, a ``file://`` rendezvous, a timeout), each rank's device, and
the runs, each a scene (a ``scene.procedural`` factory and its arguments),
a ``RenderConfig``, the raster backend, the shadow pair budget and a frame
count. Every rank renders every run through ``parallel.sharded.
ShardedRenderer``; rank 0 keeps the gathered frame of each run's last
frame and the packed shadow maps, and every rank its wall ms a frame, its
kernel launches, its counters, the collective transport and its programs'
mode, captures and replays (``program_stats``). ``launch`` returns them
as {"ranks": [rank 0's record, rank 1's, ...]}.

A run's options, beyond those: ``sync_error`` runs the frames after the
first under ``torch.cuda.set_sync_debug_mode("error")``; ``eager_frames``
N renders N more frames each replayed and then dispatched op by op
(``ShardedRenderer.render_eager``), timed in turns and held to the last
frame; ``exposure_scale`` renders one frame at the camera's exposure
times it and ``dirty_frame`` one after ``mark_shadows_dirty()`` (rank 0
keeps both). On a card every rank also counts the synchronizing calls
of one more warm frame and of those two (``tools.sync_sites``). Over NCCL the
group is bound to the rank's card (``device_id``), so its communicator
exists before the renderer captures.

A rank process imports this module and the package only (never a test
module), uses one CPU thread unless the job says otherwise, and a rank
that fails or outlives the deadline fails the launch, which then stops
every rank it started.
"""

from __future__ import annotations

import datetime
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

_ROOT = Path(__file__).resolve().parents[2]


def scene_from_spec(spec):
    """(factory name in ``scene.procedural``, kwargs) -> the host scene."""
    from ..scene import procedural

    name, kw = spec
    return getattr(procedural, name)(**kw)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _frame(r, dev, view_props=None, sync_mode=None):
    """One ``render()``; with ``sync_mode`` on a card, under that sync
    debug mode (``"error"``) or counted (``"count"``: the frame and the
    ``sync_sites`` record)."""
    from .sync_sites import sync_sites

    if sync_mode is None or dev.type != "cuda":
        return r.render(view_props), None
    if sync_mode == "count":
        out = []
        sites = sync_sites(lambda: out.append(r.render(view_props)))
        return out[0], sites
    torch.cuda.set_sync_debug_mode(sync_mode)
    try:
        return r.render(view_props), None
    finally:
        torch.cuda.set_sync_debug_mode(0)


def run_rank(job: dict, rank: int) -> dict:
    """Render the job's runs on this rank of the initialized group."""
    from ..parallel import sharded
    from ..raster import cuda_raster as cr
    from ..scene.camera import ViewProperties

    mesh = sharded.make_mesh(job["world"], device=job["devices"][rank])
    scenes = {}
    out = {"rank": rank, "transport": mesh.transport, "runs": {},
           "device": str(mesh.device)}
    for name, run in job["runs"].items():
        key = repr(run["scene"])
        if key not in scenes:
            t0 = time.perf_counter()
            scenes[key] = scene_from_spec(run["scene"])
            out.setdefault("scene_s", {})[name] = time.perf_counter() - t0
        for counts in (cr.launch_counts, cr.helper_counts):
            for k in counts:
                counts[k] = 0
        cr.variant_counts.clear()
        t0 = time.perf_counter()
        r = sharded.ShardedRenderer(scenes[key], run["config"], mesh,
                                    backend=run.get("backend", "cuda"),
                                    shadow_budget=run.get("shadow_budget"))
        _sync(mesh.device)
        dev = mesh.device
        rec = {"init_s": time.perf_counter() - t0, "ms": []}
        for i in range(run.get("frames", 1)):
            dist.barrier()
            t0 = time.perf_counter()
            (frame, stats), _ = _frame(
                r, dev, sync_mode="error" if i and run.get("sync_error")
                else None)
            _sync(dev)
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
        rec["stats"] = {k: v.tolist() for k, v in stats.items()}
        rec["shadow_overflow"] = r.shadow_overflow
        rec["launches"] = {str(k): v for k, v in cr.variant_counts.items()}
        if rank == 0:
            rec["frame"] = frame.cpu()
            if run.get("keep_shadow_maps") and r.shadow_maps is not None:
                rec["shadow_maps"] = tuple(t.cpu() for t in r.shadow_maps)
        rec["sync"] = (_frame(r, dev, sync_mode="count")[1]
                       if dev.type == "cuda" else None)
        if run.get("eager_frames"):
            times = {"replayed": [], "eager": []}
            same = []
            for _ in range(run["eager_frames"]):
                for mode, acc in times.items():
                    dist.barrier()
                    t0 = time.perf_counter()
                    img, _ = (r.render_eager() if mode == "eager"
                              else r.render())
                    _sync(dev)
                    acc.append((time.perf_counter() - t0) * 1e3)
                    same.append(torch.equal(img, frame))
            rec["replayed_ms"], rec["eager_ms"] = times["replayed"], \
                times["eager"]
            rec["eager_equal"] = all(same)
        extra = []
        if run.get("exposure_scale"):
            vp = ViewProperties.from_camera(r.scene_host.camera)
            vp.exposure = float(vp.exposure) * run["exposure_scale"]
            extra.append(("exposure", vp))
        if run.get("dirty_frame"):
            extra.append(("dirty", None))
        for tag, vp in extra:
            if tag == "dirty":
                r.mark_shadows_dirty()
            (img, st), rec[f"sync_{tag}"] = _frame(r, dev, vp,
                                                   sync_mode="count")
            rec[f"stats_{tag}"] = {k: v.tolist() for k, v in st.items()}
            rec[f"shadow_overflow_{tag}"] = r.shadow_overflow
            if rank == 0:
                rec[f"frame_{tag}"] = img.cpu()
        rec["programs"] = r.program_stats()
        out["runs"][name] = rec
        del r, frame, stats
        if mesh.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    job_path, rank = Path(argv[0]), int(argv[1])
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    torch.set_num_threads(job.get("threads", 1))
    kw = {}
    if job["dist_backend"] == "nccl":
        kw["device_id"] = torch.device(job["devices"][rank])
    dist.init_process_group(
        job["dist_backend"], init_method=job["init_method"],
        world_size=job["world"], rank=rank,
        timeout=datetime.timedelta(seconds=job["timeout_s"]), **kw)
    try:
        out = run_rank(job, rank)
        torch.save(out, job_path.parent / f"rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def launch(job: dict, work_dir, timeout_s: float = 600.0) -> dict:
    """Spawn ``job["world"]`` rank processes on ``job`` (see the module
    docstring; ``init_method`` defaults to a fresh rendezvous file in
    ``work_dir``) and join them within ``timeout_s`` seconds. Raises
    RuntimeError if a rank fails or the deadline passes (every rank still
    running is killed first), with the tail of each rank's log."""
    work = Path(work_dir)
    work.mkdir(parents=True, exist_ok=True)
    job = dict(job)
    job.setdefault("timeout_s", timeout_s)
    job.setdefault("init_method", f"file://{work.resolve() / 'rendezvous'}")
    job_path = work / "job.pkl"
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    penv = dict(os.environ)
    penv["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in [penv.get("PYTHONPATH")] if p])
    penv.setdefault("OMP_NUM_THREADS", str(job.get("threads", 1)))
    procs, logs = [], []
    for rank in range(job["world"]):
        log = open(work / f"rank{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "renderengine_tpu_torch.tools.sharded_run",
             str(job_path), str(rank)], stdout=log, stderr=subprocess.STDOUT,
            env=penv, cwd=str(_ROOT)))
    deadline = time.monotonic() + timeout_s
    err = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [i for i, p in enumerate(procs)
                   if p.returncode not in (None, 0)]
            if bad:
                err = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
                break
            if time.monotonic() > deadline:
                err = f"ranks still running after {timeout_s:.0f} s"
                break
            time.sleep(0.05)
        else:
            bad = [i for i, p in enumerate(procs) if p.returncode != 0]
            if bad:
                err = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for log in logs:
            log.close()
    if err:
        tails = "\n".join(
            f"--- rank {r} ---\n" + (work / f"rank{r}.log").read_text()[-3000:]
            for r in range(job["world"]))
        raise RuntimeError(f"sharded launch failed: {err}\n{tails}")
    return {"ranks": [torch.load(work / f"rank{r}.pt", weights_only=False)
                      for r in range(job["world"])]}


if __name__ == "__main__":
    sys.exit(main())
