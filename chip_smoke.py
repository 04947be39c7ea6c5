"""GPU smoke test of the PyTorch port (``renderengine_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds every kernel of the port's paths from the sources in the
checkout (the tile raster K1 and the merged raster K2, both in
``csrc/raster_tile.cu``, the tiered anisotropic sampler,
``csrc/aniso_slots.cu``, and the texture-space peel pass,
``csrc/tss_peel.cu``: one ``nvcc``), holds each kernel against its plain PyTorch version on the card (random
triangles in every mode; the dense-tile stress scene of
``tools/split_stress.py``, whose tile the kernels split into 8 work items
and more and merge, with forced ties (phase split-stress); then every
launch shape of the paths at full size: the opaque 1080p pass, the sun's
4096^2 depth-only shadow pass, the dual-peel pass over the translucent
list; K1 at 4 attributes and K2 at the texture-space 1080p launch),
renders the seven golden configs at their
bar, and drives two paths through the user entry point on the procedural
Sponza (260k triangles, 200 textures of 512^2), checking their output:

- the per-pixel path: ``FrameRenderer(scene, RenderConfig(width=1920,
  height=1080)).render()``, the default configuration (4096^2 shadow maps
  with 3x3 PCF, skybox, two depth-peeled translucent layers, PBR with 16x
  tiered anisotropic sampling); the opaque-only frame of the first slice
  is still driven once;
- the texture-space path: the JAX package's headline configuration
  (``texture_space``, ``tss_preshaded_blend``, ``dither_trilinear``,
  ``sky_halfres``; charts at density 0.5 within 2M texels), where one K2
  launch a frame rasters the opaque pass and both translucent layers;
  the same frame through separate K1 launches (a test hook, uncounted;
  its peels go through ``shade_sparse`` with every tile of every tile row
  selected, shaded per pixel as the peel kernel shades the merged ones);
  then one frame each of factored texture-space shading (4 translucent
  layers: K2 and a K1 dual peel), fully pre-shaded shading and shading
  without translucency (where K1 at 4 attributes rasters the opaque pass).
  Each of these frames is rendered again through the plain versions and
  must come out identical;
- the app path (phase app-path): ``engine.init()``, then
  ``apps.main_sample.main()`` in process on the Sponza at 1920x1080 with
  the app's defaults (2048^2 shadow maps): 5 per-pixel frames, 5
  ``--textureSpace`` frames (one K2 launch a frame) and 8 ``--orbit
  --hud`` frames, through ``RenderLoop`` (two frames in flight) and the
  non-blocking overflow poll; then ``apps.live_viewer.main()`` for 3
  frames. Every PNG decodes to 1080x1920 RGBA8; the check waits for the
  first frame before the second renders (the app does not), so from the
  second frame on every counter is 0 and each frame equals ``render()``
  with the config it rendered with, byte for byte (frames 3-5 with the
  final one; frame 2 may precede the first shade-budget re-tune, which
  moves pixels within the golden bar: ROADMAP F9); K1/K2 launches are
  counted per frame; on warm frames the poll runs under
  ``torch.cuda.set_sync_debug_mode("error")``. It also logs
  the budgets and the peel-shade span's kernel time before and after the
  re-tunes, the synchronizing calls of a warm ``render()``, the
  app's 2048^2 shadow launch against its plain version, and the wall ms
  a frame of ``RenderLoop`` against ``render()`` + ``.cpu()``;
- the compiled frame (phase graph-path): on a CUDA device
  ``FrameRenderer`` captures its frame and its shadow pass into CUDA
  graphs at init and after every budget change, and ``render()`` replays
  them. For the per-pixel default, the texture-space headline and the
  app's per-pixel config (2048^2 maps), each with the overflow poll on:
  3 warm ``render()`` calls under ``torch.cuda.set_sync_debug_mode
  ("error")`` that replay the frame program (no capture, no eager frame,
  the launches of 3 frames); for 3 camera poses the replayed frame equals
  ``render_frame`` dispatched op by op at the same budgets, byte for
  byte, every counter 0; a pair overflow fed to the poll recaptures, and
  the frame after it and the frame after ``mark_shadows_dirty()`` equal
  their eager frames; it prints the capture and instantiate ms, the
  graph pools' bytes, the warm frame ms replayed against eager (median of
  10 each, alternating), ``torch.profiler``'s busy share and kernels a
  frame over replays and over one eager frame, and ``RenderLoop`` against
  ``render()`` + ``.cpu()``. For the texture-space headline it also
  captures the visibility and light-table bakes at init (the JAX
  ``_vis_fn`` and ``_ld_fn``): an exposure-change frame replays the
  table program and the frame under ``set_sync_debug_mode("error")``, a
  shadow-dirty frame replays the shadow, visibility, table and frame
  programs with one synchronizing call, the shadow pass's overflow read
  (``tools.sync_sites``); both equal the bakes and the frame dispatched
  op by op, byte for byte; it prints both kinds of frame replayed
  against eager (median of 5 each, alternating), the host ms of the
  dirty frame's shadow refit, and the bake programs' capture and
  instantiate ms and pool bytes;
- the sharded path (phase sharded, ``parallel.sharded.ShardedRenderer``
  through ``tools.sharded_run``): 2 rank processes on the one card over
  gloo (NCCL puts no two ranks on one device; the gathers go through
  host memory), each rendering its 540-row band of the 1080p frame (from
  the whole 8-row tile it starts in: 544 rows, rank 1's from row 536), 3
  frames of the default per-pixel config and 3 of the texture-space
  headline, with the budgets the single-card renderers settled on; each
  gathered frame must equal the single-card frame and the sharded shadow
  maps (each rank rasters half the triangles, merged by
  ``all_reduce(MIN)``) the single-card ones, byte for byte, every
  counter 0, both ranks eager (gloo's collectives run on the host);
  then both configs at a world of 1 over NCCL through the same code,
  where the renderer captures the band frame (the vertex and band
  gathers, the reductions), the sharded shadow pass and the TSS bakes
  at init: 3 frames (the 2 warm ones under ``set_sync_debug_mode
  ("error")``), equal to the single card's, one more with 0
  synchronizing calls, 2 replayed frames against 2 eager ones in turns
  (equal), and a shadow-dirty frame with one call, the overflow read,
  equal to the warm frame. Phases k1-band and k2-band first hold K1 (the opaque
  pass at 8 attributes, the dual peel) and K2 at a launch from the
  mid-tile row y0 = 540 and at rank 1's launch shapes (y0 = 536, 544
  rows) to their plain versions and time the latter; their rows'
  ``launches`` are rank 1's in that run. The
  frame times of two ranks sharing one card are a record, not a scaling
  claim;
- the benchmark's orbit (phase orbit, ``bench_torch.py``'s ``Orbit``,
  ``settle`` and ``timed_rounds``): the texture-space headline at 1080p
  settles over whole orbits of 30 frames (the camera turns 0.02 rad a
  frame; ``settle_orbits`` and ``settle_recaptures`` are printed), then
  renders one round of 30 frames in flight; 8 orbit frames of the
  per-pixel default follow in one round; at one orbit pose each replayed
  frame equals ``render_eager()`` byte for byte, every counter 0, and the
  K1/K2 launches are those of the frames and captures counted;
- SSAA x2 (phase ssaa2): the headline and the per-pixel default at
  ``ssaa=2``, 3840x2160 inside: each renderer captures and replays, every
  counter is 0 once the first frame's are consumed, a replayed frame
  equals ``render_eager()`` byte for byte, a warm headline frame makes no
  synchronizing call (``tools.sync_sites``); from the renderers' own
  tables K2 at the headline and K1's per-pixel opaque pass (8 attributes)
  and dual peel at 3840x2160, each bit-exact against its plain version
  (``max_abs_err`` 0.0) and timed; the rows' ``launches`` are those of
  the phase's frames. Then the workspace check: the headline renderer of
  phase orbit, captured before the 4K launches grew the split walk's
  workspace (its graph keeps the older tensors), replays its frame at an
  orbit pose byte-equal to its frame there from before the growth;
- the tiered anisotropic sampler (phase aniso): the per-pixel default
  settles over ``ANISO_SETTLE`` orbit frames (3 sampler launches a
  frame), and at pose ``ANISO_POSE`` its eager frame's opaque call
  (1920x1080) and first peel layer shaded on its compacted pseudo-image
  (128 wide) are held bit for bit against the plain version and timed,
  each beside its bytes bound (``aniso_bound``: the taps actually taken);
- the texture-space peel pass (phase tss-peel, ``csrc/tss_peel.cu``): the
  headline at 1080p and at ``ssaa=2`` renders ``PEEL_FRAMES`` orbit
  frames (one peel launch a frame, no observed shade tiles), and at pose
  ``PEEL_POSE`` its eager frame's peel call (1920x1080, 3840x2160) is held
  bit for bit against the plain version (eager, a row band, replayed from
  a CUDA graph) and timed beside its bytes bound (``tss_peel_bound``);
  the frame with the plain version in its place is the same;
- the factored texture-space screen pass (phase tss-shade,
  ``csrc/tss_shade.cu``): the same frames and pose; its call (1920x1080,
  3840x2160) held bit for bit against the plain version (eager, a band
  starting on the odd row 537, replayed from a CUDA graph) and timed
  beside its bytes bound (``tss_shade_bound``); the frame with the plain
  version in its place is the same.
- the point-light cube shadow (phase k1-cube, ``cube_face_phase``): the
  TSS headline over ``sponza_cube_scene`` (the nave lamp's six 4096^2
  faces after the sun's and the spot's maps) renders 3 shadow-dirty
  frames (8 depth-only K1 launches a shadow pass, 6 of them the faces;
  no pair dropped); each face's K1
  launch is held bit for bit against its plain version and timed
  (``time_shape``) beside its bound (``k1_bound``); the kernel row is
  the densest face, the one with the most pairs (the face looking down
  is nearly empty: the depth pass culls front faces, and the floor faces
  the lamp). It runs alone with
  ``python3 -c "import chip_smoke; chip_smoke.cube_face_main()"``.
Each phase is fatal: any failure exits non-zero without the final line.
Before the last line it prints the card's name and power limit (as
``nvidia-smi`` reports them), one JSON line of per-kernel numbers and one
of timings; the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Numbers: kernel times are medians of CUDA-event-timed launches at the
paths' launch shapes (the median of three rounds of 30), each beside the
same launch captured alone in a CUDA graph (``in_graph_ms``: the median
of 30 replays, no host wrapper), the launch with only its densest tile
left, the ratio of the two, ``torch.profiler``'s device time and the
host time a call takes to reach its launch (calls issued back to back);
plain-version times one CUDA-event-timed run; ``bound_ms`` is the larger
of (bytes moved / 3.35 TB/s) and (operations / 67 TFLOP/s FP32), counted
from this run's inputs; the texture-space bakes and the specular chart
pass are CUDA-event-timed calls (host dispatch included); frame times are
host clock around ``render()`` followed by a synchronize. The launch
counts are set to 0 just before each path is driven and read just after;
a captured program adds the launches its capture recorded at each replay
(the capture itself launches nothing), and a capture's warm-up frame
counts as the frame it is; each kernel row's ``launches`` is that of the
path whose launch shape it was timed at (K2 at 2 blend attributes: the
headline frames; K2 at 4 and K1's texture-space dual peel: the factored
frame; K1's texture-space opaque pass: the frame without translucency).
Every number in the kernel line is measured in this run (``bound_ms`` is
computed from it); the one-block-per-tile kernels' times before the split
walk, on the same card type, are printed apart as
history (``BEFORE_SPLIT_MS``).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path
from unittest import mock

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12        # H100 SXM non-tensor FP32, NVIDIA data sheet
SPONZA_W, SPONZA_H = 1920, 1080
N_FRAMES = 3
SOURCE = "renderengine_tpu_torch/csrc/raster_tile.cu"
REPLACES = "renderengine_tpu/raster/pallas_raster.py:122"
K2_REPLACES = "renderengine_tpu/raster/pallas_raster.py:419"
TSS_FRAMES = 3
# phase orbit: frames of the TSS headline's orbit (bench_torch's default)
# and of the per-pixel default's round; the pose held to eager and the
# one the workspace check replays
ORBIT_FRAMES, ORBIT_PP_FRAMES, POSE, WS_POSE = 30, 8, 7, 11
# phase aniso: the per-pixel default settles over the orbit's first
# ANISO_SETTLE frames (the benchmark's pp.orbit settles 192), then its
# sampler calls are taken at pose ANISO_POSE, inside the benchmark's window
ANISO_SETTLE, ANISO_POSE = 192, 300
ANISO_SOURCE = "renderengine_tpu_torch/csrc/aniso_slots.cu"
# phase tss-peel: the headline (1080p and ssaa=2) renders PEEL_FRAMES orbit
# frames, then its peel call is taken at pose PEEL_POSE
PEEL_FRAMES, PEEL_POSE = 64, 300
PEEL_SOURCE = "renderengine_tpu_torch/csrc/tss_peel.cu"
# phase tss-shade: the same frames and pose for the factored screen pass
SHADE_SOURCE = "renderengine_tpu_torch/csrc/tss_shade.cu"
# history, not measured by this run: the one-block-per-tile kernels'
# times before the split walk on an NVIDIA H100 80GB HBM3 at 700.00 W
# (PERF.md, from this script as it was then), and the warm frames
BEFORE_SPLIT_MS = {"raster_tile": 0.7499839961528778,
                   "raster_tile_shadow": 0.48393601179122925,
                   "raster_tile_peel2": 0.11105599999427795,
                   "raster_tile_tss": 0.6909599900245667,
                   "raster_tile_tss_peel2": 0.09761599823832512,
                   "merged_tile": 0.6885760128498077,
                   "merged_tile_b4": 0.7109120190143585}
BEFORE_SPLIT_FRAME_MS = {"per_pixel": [865.0, 905.0], "tss": [42.1, 39.0]}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(phase: str, exc: BaseException | None = None) -> None:
    if exc is not None:
        traceback.print_exc()
    print(f"chip_smoke: FAILED in phase {phase}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    """Median over ``reps`` calls of ``fn`` timed with CUDA events (after
    one warm-up call)."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int, sessions: int = 3,
              kernels=("raster_tile_kernel", "merged_tile_kernel")
              ) -> float | None:
    """Device-side duration of one launch of the kernel (by default the
    raster kernel, K1 or K2; ``kernels``: substrings of the kernel's
    name) that ``fn`` launches: the mean over the kernel's records in
    ``torch.profiler`` sessions of ``reps`` calls (after one warm-up
    call). The profiler has shown fewer records than launches for some
    launch shapes, so up to ``sessions`` sessions run until one shows all
    ``reps``; None where none shows any."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    us = []
    for _ in range(sessions):
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 — the numbers are then missing
            log(f"  torch.profiler failed ({e!r}): device time not measured")
            return None
        got = [e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == cuda
               and any(k in e.name for k in kernels)]
        us += got
        if len(got) >= reps:
            break
    return sum(us) / len(us) / 1e3 if us else None


def solo_counts(*counts):
    """Copies of the counts with every tile but the densest (by the sum
    over the tables) emptied: that tile alone, in a launch of the same
    grid."""
    dense = int(sum(c.long() for c in counts).argmax())
    out = []
    for c in counts:
        solo = torch.zeros_like(c)
        solo[dense] = c[dense]
        out.append(solo)
    return out


def host_ms(fn, reps: int) -> float:
    """Host time per call of ``fn`` (the wrapper's checks, allocation and
    launch), over ``reps`` calls issued back to back with no wait."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def graph_ms(fn, reps: int = 30) -> float:
    """The CUDA-event median over ``reps`` replays of one call of ``fn``
    captured in a CUDA graph: the launch without its host wrapper. The
    capture launches nothing, so its counts are taken back out."""
    from renderengine_tpu_torch.raster import cuda_raster as cr

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                     # the workspace becomes the side stream's
        snap = cr.count_snapshot()
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        fn()
        graph.capture_end()
        cr.add_counts(cr.counts_since(snap), -1)
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    del graph
    return statistics.median(times)


def time_shape(label, fn, solo_fn, reps=30):
    """A launch shape's numbers: the CUDA-event median over ``reps``
    launches (the median of three such rounds, which differ by the host's
    noise), the same launch replayed from a CUDA graph (median over
    ``reps`` replays), the densest tile alone (median over ``reps``), the
    ratio of the two, the profiler's device time per launch of the kernel
    and the host time per call."""
    rounds = [cuda_ms(fn, reps) for _ in range(3)]
    ms = statistics.median(rounds)
    densest = cuda_ms(solo_fn, reps)
    r = {"ms": ms, "rounds_ms": rounds, "in_graph_ms": graph_ms(fn, reps),
         "densest_tile_ms": densest,
         "launch_over_densest": ms / densest, "device_ms": device_ms(fn, 10),
         "host_ms": host_ms(fn, reps)}
    log(f"  times [{label}]: {r}")
    return r


def ref_frame_ms(fn, reps: int = 3) -> list:
    """Host ms of ``reps`` warm frames, each call followed by a
    synchronize: the single-card frame the sharded phase is compared
    with, at the same budgets (no poll in between)."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def expected_launches(warm: dict, caps: dict, n_maps: int,
                      shadow_v) -> dict:
    """The K1/K2 launches of one ``render()`` by variant, from the
    renderer's program counts of that call (``caps``: the change of
    ``FrameRenderer.program_counts``): one frame's ``warm`` launches for
    the replay and as many again for each capture's warm-up frame, and
    ``n_maps`` shadow launches for each shadow replay and capture."""
    want = {v: n * (caps["frame_replays"] + caps["frame_captures"])
            for v, n in warm.items()}
    want[shadow_v] = n_maps * (caps["shadow_replays"]
                               + caps["shadow_captures"])
    return {v: n for v, n in want.items() if n}


def counts_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in before}


def loop_vs_sequential(r, n=10):
    """Wall ms a frame: RenderLoop with two frames in flight, then
    render() + .cpu() one frame at a time, on one renderer."""
    from renderengine_tpu_torch.graph import render_loop

    with mock.patch.object(render_loop, "FrameRenderer",
                           lambda *a, **k: r):
        loop = render_loop.RenderLoop(r.scene_host, r.config,
                                      target_fps=0.0)
    for _ in range(2):
        loop.render_one()
    loop.drain()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        loop.render_one()
    loop.drain()
    loop_ms = (time.perf_counter() - t0) * 1e3 / n
    t0 = time.perf_counter()
    for _ in range(n):
        r.render()[0].cpu()
    seq_ms = (time.perf_counter() - t0) * 1e3 / n
    return {"loop_ms": loop_ms, "sequential_ms": seq_ms}


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    d = (a.double() - b.double()).abs()
    return float(d.max()) if d.numel() else 0.0


def k1_plain_check(cr, prep, ntx, width, height, label, bounds=None,
                   tile_map=None, dual=False, y0=0):
    """K1 against its plain version on the card over one pair table:
    depth, tri and material planes of every layer bit-exact; attribute
    planes within 1e-6 (absolute, on values of at most a few hundred).
    ``height`` is the full frame's, ``y0`` a band's first row.
    Returns (max abs error, the plain run's stats: (pair, pixel) fragments
    that entered a layer and layer-1 demotions, the plain run's ms)."""
    b = prep.bins
    args = (prep.pair_data, b.starts, b.counts, ntx, width, height, y0,
            prep.n_attrs, bounds, tile_map, dual)
    kern = cr.raster_tiles(*args)
    stats = {}
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    plain = cr._raster_tiles_plain(*args, stats=stats)
    t1.record()
    torch.cuda.synchronize()
    pp = kern.shape[1] // (2 if dual else 1)
    ids = [c for lb in range(0, kern.shape[1], pp) for c in range(lb, lb + 3)]
    exact = torch.equal(kern[:, ids], plain[:, ids])
    err = max_abs_err(kern, plain)
    log(f"  K1 vs plain [{label}]: ids+depth exact={exact}, "
        f"max_abs_err={err!r}")
    if not exact or err > 1e-6:
        raise AssertionError(f"K1 disagrees with its plain version ({label})")
    return err, stats, t0.elapsed_time(t1)


def k2_check(cr, pa, pb, ntx, width, height, nab, label, y0=0):
    """K2 against its plain version on the card, and against K1's opaque
    launch followed by K1's dual launch with peel bounds (-1, opaque
    depth) over the same tables: all bit-exact. Returns (max abs error,
    the plain run's stats, the plain run's ms)."""
    tabs = (pa.pair_data, pa.bins.starts, pa.bins.counts, pb.pair_data,
            pb.bins.starts, pb.bins.counts, ntx, width, height, y0, nab)
    kern = cr.merged_tiles(*tabs)
    stats = {}
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    plain = cr._merged_tiles_plain(*tabs, stats=stats)
    t1.record()
    torch.cuda.synchronize()
    # the separate launches: opaque, then the bounded dual peel (bounds in
    # tile order, so partial tiles' outside pixels see the same cap)
    opq = cr.raster_tiles(pa.pair_data, pa.bins.starts, pa.bins.counts,
                          ntx, width, height, y0, 4)
    bounds = torch.stack([torch.full_like(opq[:, 0], -1.0), opq[:, 0]],
                         1).contiguous()
    dual = cr.raster_tiles(pb.pair_data, pb.bins.starts, pb.bins.counts,
                           ntx, width, height, y0, 4, bounds, None, True)
    pl = 3 + nab
    sep = torch.cat([opq, dual[:, :pl], dual[:, 7:7 + pl]], 1)
    err = max(max_abs_err(kern, plain), max_abs_err(kern, sep))
    exact = torch.equal(kern, plain) and torch.equal(kern, sep)
    log(f"  K2 vs plain and vs K1 opaque + K1 bounded dual [{label}]: "
        f"exact={exact}, max_abs_err={err!r}")
    if not exact:
        raise AssertionError(f"K2 disagrees ({label})")
    return err, stats, t0.elapsed_time(t1)


def k2_bound(pairs_a, pairs_b, n_tiles, nab, wins_a, wins_b, demotes):
    """The least time the card could take for one K2 launch, from this
    run's counts: (ms, by, operations, bytes). Bytes: every pair row of
    both tables read once (32 floats), both tables' starts/counts once,
    the 7 + 2 * (3 + nab) output planes written once. Operations: K1's
    count for a single walk over table A (4 attributes) plus a dual walk
    over table B (nab attributes), and the fold's two cap compares and
    selects per pixel."""
    bytes_moved = ((pairs_a + pairs_b) * 32 * 4 + 4 * 4 * n_tiles
                   + (7 + 2 * (3 + nab)) * 4 * n_tiles * 256)
    carried_a, carried_b = 4 + 4, 4 + nab
    ops = (pairs_a * 256 * 31 + wins_a * (4 * 4 + 2 + carried_a)
           + pairs_b * 256 * 33 + wins_b * (4 * nab + 2 + carried_b)
           + demotes * carried_b
           + n_tiles * 256 * ((3 + 4) + 2 * (3 + nab) + 4))
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_bytes, t_ops), by, ops, bytes_moved


def k1_bound(pairs, n_slots, cpp, n_attrs, wins, demotes=0, peel=False,
             dual=False, sparse=False):
    """The least time the card could take for one K1 launch, from this
    run's counts: (ms, by, operations, bytes).

    Bytes: every pair row of the walked tiles read once, starts/counts
    (and the tile map) once, the bounds planes once, every output plane
    written once. Operations: every pair-pixel costs 5 planes (2 mul + 2
    add each), 3 tie-eps adds, the depth divide, 6 coverage compares and
    the depth test (31; 2 more compares with peel bounds, 2 more for the
    second layer); only a fragment that enters a layer (counted by the
    plain run) adds the attribute planes (or nothing: the two barycentric
    numerators are the edge values), the edge sum's 2 adds and the carried
    values; a layer-1 win of a dual walk also moves the old layer down;
    every pixel ends, per layer, with a compare, a select, the reciprocal
    and one multiply per numerator."""
    n_num = n_attrs if n_attrs else 2
    layers = 2 if dual else 1
    carried = 4 + n_num
    bytes_moved = (pairs * cpp * 4 + (3 if sparse else 2) * 4 * n_slots
                   + (2 * 256 * 4 * n_slots if peel else 0)
                   + layers * (3 + n_num) * 4 * n_slots * 256)
    ops_per_pair_px = 4 * 5 + 3 + 1 + 7 + (2 if peel else 0) \
        + (2 if dual else 0)
    ops_per_win = 4 * n_attrs + 2 + carried
    ops = (pairs * 256 * ops_per_pair_px + wins * ops_per_win
           + demotes * carried + n_slots * 256 * layers * (3 + n_num))
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_bytes, t_ops), by, ops, bytes_moved


def over_counts(stats: dict, r=None) -> dict:
    """A frame's overflow counters (and its renderer's shadow pass's)."""
    out = {k: int(v) for k, v in stats.items() if "overflow" in k}
    if r is not None:
        out["shadow_overflow"] = r.shadow_overflow
    return out


def orbit_phase(fr, cr, scene, tss_cfg, pp_cfg, dev, reset_counts):
    """Phase orbit: the benchmark's orbiting camera (``bench_torch``) on
    the TSS headline at 1080p, settled through the controller and the
    captured frame (``settle_orbits``, ``settle_recaptures``), one timed
    round of ``ORBIT_FRAMES`` frames in flight; at one orbit pose the
    replayed frame equals the eager frame byte for byte and every counter
    is 0; the K2 and shadow launches are those of the frames and captures
    counted. Then ``ORBIT_PP_FRAMES`` orbit frames of the per-pixel
    default in one round, with the same check at one pose. Returns the
    record and, for the workspace check, the TSS renderer (its poll off)
    with its frame at orbit pose ``WS_POSE``."""
    import bench_torch

    t_phase = time.time()
    orbit = bench_torch.Orbit(scene.camera)
    k2_v2, shadow_v = ("merged", 2), (0, False, False)
    opaque_v, peel_v = (8, False, False), (8, True, True)
    res = {}
    keep = None
    try:
        for tag, cfg, frames, warm in (
                ("tss_headline", tss_cfg, ORBIT_FRAMES, {k2_v2: 1}),
                ("per_pixel", pp_cfg, ORBIT_PP_FRAMES,
                 {opaque_v: 1, peel_v: 1})):
            r = fr.FrameRenderer(scene, cfg)
            r.render()
            torch.cuda.synchronize()
            reset_counts()
            p0 = dict(r.program_counts)
            rec = {}
            if tag == "tss_headline":
                rec.update(bench_torch.settle(r, orbit, frames, dev))
                log(f"phase orbit [{tag}]: settle_orbits "
                    f"{rec['settle_orbits']}, settled {rec['settled']}, "
                    f"settle_recaptures {rec['settle_recaptures']}")
            rec.update(bench_torch.timed_rounds(r, orbit, frames, 1, dev))
            img, st = r.render(orbit.vp(POSE))
            torch.cuda.synchronize()
            caps = counts_delta(p0, r.program_counts)
            got = {str(v): n for v, n in cr.variant_counts.items() if n}
            want = {str(v): n for v, n in expected_launches(
                warm, caps, r.n_shadows, shadow_v).items()}
            e_img, e_st = r.render_eager()
            rec.update({"pose": POSE, "equal": torch.equal(img, e_img),
                        "counters": over_counts(st, r),
                        "eager_counters": over_counts(e_st),
                        "programs": caps, "launches": got})
            log(f"phase orbit [{tag}]: {rec}")
            if (not rec["equal"] or any(rec["counters"].values())
                    or any(rec["eager_counters"].values())
                    or any(rec["last_round_counters"].values())
                    or not rec["frames_0_1_differ"] or got != want):
                raise AssertionError(f"orbit {tag}: {rec}, launches "
                                     f"expected {want}")
            res[tag] = rec
            if tag == "tss_headline":
                # the workspace check's reference: this renderer's frame
                # at one pose, its budgets frozen from here on
                r._react_overflow = False
                ws_img = r.render(orbit.vp(WS_POSE))[0].cpu()
                keep = (r, ws_img, r.program_counts["frame_captures"])
            del r, img, e_img
            torch.cuda.empty_cache()
    finally:
        orbit.restore()
    res["wall_s"] = time.time() - t_phase
    log(f"phase orbit: {res['wall_s']:.1f} s")
    return res, keep


def ssaa2_phase(fr, cr, scene, tss_cfg, pp_cfg, dev, reset_counts, times,
                rows):
    """Phase ssaa2: the TSS headline and the per-pixel default at
    ``ssaa=2`` (3840x2160 inside) through ``FrameRenderer``: the frames
    capture and replay, every counter is 0 once the first frame's are
    consumed, a replayed frame equals ``render_eager()`` byte for byte,
    and a warm TSS frame makes no synchronizing call. Then the three
    launch shapes at 3840x2160 from the renderers' own tables, each
    bit-exact against its plain version and timed: K2 at the headline
    (n_attrs_b 2), K1's per-pixel opaque pass (n_attrs 8) and K1's
    per-pixel dual peel. Fills ``times`` and ``rows`` (per kernel row:
    launches in this phase's frames, error, plain ms, bound, pairs)."""
    from renderengine_tpu_torch.tools.sync_sites import sync_sites

    t_phase = time.time()
    w4, h4 = 2 * SPONZA_W, 2 * SPONZA_H
    ntx4, nty4 = -(-w4 // cr.TILE_W), -(-h4 // cr.TILE_H)
    n_tiles4 = ntx4 * nty4
    k2_v2, shadow_v = ("merged", 2), (0, False, False)
    opaque_v, peel_v = (8, False, False), (8, True, True)
    res = {}

    def frames(r, n=4):
        """n frames, each synchronized: the first frame's counters are
        consumed by the second's poll; returns the last frame's."""
        for _ in range(n):
            img, st = r.render()
            torch.cuda.synchronize()
        return img, st

    def frame_ms(fn, n):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    for tag, cfg, warm, n_time in (
            ("tss_headline_ssaa2", tss_cfg.replace(ssaa=2), {k2_v2: 1}, 10),
            ("per_pixel_ssaa2", pp_cfg.replace(ssaa=2),
             {opaque_v: 1, peel_v: 1}, 3)):
        t_mode = time.time()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.time()
        r = fr.FrameRenderer(scene, cfg)
        torch.cuda.synchronize()
        rec = {"init_s": time.time() - t0}
        img, st = frames(r)
        got_imgs = []
        sites = sync_sites(lambda: got_imgs.append(r.render()))
        img, st = got_imgs[0]
        torch.cuda.synchronize()
        caps = dict(r.program_counts)
        got = {str(v): n for v, n in cr.variant_counts.items() if n}
        want = {str(v): n for v, n in expected_launches(
            warm, caps, r.n_shadows, shadow_v).items()}
        launches = dict(cr.variant_counts)
        e_img, e_st = r.render_eager()
        rec.update({"shape": list(img.shape),
                    "render_extent": list(r.config.render_extent()),
                    "sync_warm_frame": sites, "equal": torch.equal(img,
                                                                   e_img),
                    "counters": over_counts(st, r),
                    "eager_counters": over_counts(e_st),
                    "programs": r.program_stats(), "launches": got})
        rec["frame_ms"] = {"replayed": frame_ms(r.render, n_time),
                           "eager": frame_ms(r.render_eager, 2)}
        rec["frame_ms"]["replayed_median"] = statistics.median(
            rec["frame_ms"]["replayed"])
        rec["frame_ms"]["eager_median"] = statistics.median(
            rec["frame_ms"]["eager"])
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        log(f"phase ssaa2 [{tag}]: {rec}")
        if (rec["shape"] != [SPONZA_H, SPONZA_W, 4] or not rec["equal"]
                or any(rec["counters"].values())
                or any(rec["eager_counters"].values()) or got != want
                or (tag.startswith("tss") and sites["calls"])):
            raise AssertionError(f"ssaa2 {tag}: {rec}, launches expected "
                                 f"{want}")
        # the 3840x2160 launch shapes, from this renderer's tables at the
        # camera's pose
        sd, rc = r.scene_dev, r.config
        params = fr.unpack_params(r._u, r.n_shadows)
        setup_a = fr.opaque_setup(sd, params, rc, r._has_mask)
        prep_a = fr.opaque_pairs(sd, setup_a, rc)
        ba = prep_a.bins
        if int(ba.n_overflow) or int(ba.n_tail):
            raise AssertionError(f"{tag}: opaque pair overflow at 4K")
        setup_b = fr.blend_setup(sd, params, rc)
        prep_b = fr.blend_pairs(sd, setup_b, rc)
        bb = prep_b.bins
        if int(bb.n_overflow) or int(bb.n_tail):
            raise AssertionError(f"{tag}: blend pair overflow at 4K")
        pairs_a, pairs_b = int(ba.counts.sum()), int(bb.counts.sum())
        if tag.startswith("tss"):
            err, st_k2, plain_ms = k2_check(
                cr, prep_a, prep_b, ntx4, w4, h4, 2,
                f"headline {w4}x{h4}, n_attrs_b=2")
            k2_args = (prep_a.pair_data, ba.starts, ba.counts,
                       prep_b.pair_data, bb.starts, bb.counts, ntx4, w4, h4,
                       0, 2)
            sa, sb = solo_counts(ba.counts, bb.counts)
            times["merged_tile_4k"] = time_shape(
                f"K2 {w4}x{h4}", lambda: cr.merged_tiles(*k2_args),
                lambda: cr.merged_tiles(*k2_args[:2], sa, *k2_args[3:5], sb,
                                        *k2_args[6:]))
            rows["merged_tile_4k"] = {
                "launches": launches.get(k2_v2, 0), "err": err,
                "plain_ms": plain_ms, "pairs": pairs_a + pairs_b,
                "bound": k2_bound(pairs_a, pairs_b, n_tiles4, 2,
                                  st_k2["wins"], st_k2["wins_b"],
                                  st_k2["demotes"])}
        else:
            err, st_o, plain_ms = k1_plain_check(
                cr, prep_a, ntx4, w4, h4, f"per-pixel opaque {w4}x{h4}")
            o_args = (prep_a.pair_data, ba.starts, ba.counts, ntx4, w4, h4,
                      0, 8)
            (o_solo,) = solo_counts(ba.counts)
            times["raster_tile_4k"] = time_shape(
                f"per-pixel opaque {w4}x{h4}",
                lambda: cr.raster_tiles(*o_args),
                lambda: cr.raster_tiles(*o_args[:2], o_solo, *o_args[3:]))
            rows["raster_tile_4k"] = {
                "launches": launches.get(opaque_v, 0), "err": err,
                "plain_ms": plain_ms, "pairs": pairs_a,
                "bound": k1_bound(pairs_a, n_tiles4,
                                  prep_a.pair_data.shape[1], 8,
                                  st_o["wins"])}
            depth = cr.rasterize_cuda(setup_a, h4, w4,
                                      prepared=prep_a)[0].depth
            bounds = cr._tile_bounds(
                (torch.full_like(depth, -1.0), depth), h4, w4, nty4, ntx4)
            tile_map = (cr.sparse_tile_map(bb.counts, rc.blend_tile_budget)
                        if rc.blend_tile_budget < n_tiles4 else None)
            n_sel = n_tiles4 if tile_map is None else int(tile_map.shape[0])
            perr, st_p, p_plain_ms = k1_plain_check(
                cr, prep_b, ntx4, w4, h4,
                f"per-pixel dual peel {w4}x{h4}, {n_sel} of {n_tiles4} "
                f"tiles", bounds, tile_map, True)
            p_args = (prep_b.pair_data, bb.starts, bb.counts, ntx4, w4, h4,
                      0, 8, bounds, tile_map, True)
            (p_solo,) = solo_counts(bb.counts)
            times["raster_tile_peel2_4k"] = time_shape(
                f"per-pixel dual peel {w4}x{h4}",
                lambda: cr.raster_tiles(*p_args),
                lambda: cr.raster_tiles(*p_args[:2], p_solo, *p_args[3:]))
            p_pairs = int(bb.counts.sum() if tile_map is None
                          else bb.counts[tile_map.long()].sum())
            rows["raster_tile_peel2_4k"] = {
                "launches": launches.get(peel_v, 0), "err": perr,
                "plain_ms": p_plain_ms, "pairs": p_pairs,
                "bound": k1_bound(p_pairs, n_sel, prep_b.pair_data.shape[1],
                                  8, st_p["wins"], st_p["demotes"],
                                  peel=True, dual=True,
                                  sparse=tile_map is not None)}
            del depth, bounds
        rec["workspace_bytes"] = cr.workspace_bytes()
        rec["wall_s"] = time.time() - t_mode
        res[tag] = rec
        del r, img, e_img, prep_a, prep_b, setup_a, setup_b
        torch.cuda.empty_cache()
    for name in ("merged_tile_4k", "raster_tile_4k", "raster_tile_peel2_4k"):
        b = rows[name]
        log(f"phase ssaa2 [{name}]: {b['pairs']} pairs, max_abs_err "
            f"{b['err']!r}, {times[name]['ms']:.4f} ms (in a graph "
            f"{times[name]['in_graph_ms']:.4f}), plain {b['plain_ms']:.2f} "
            f"ms, bound {b['bound'][0]:.4f} ms ({b['bound'][1]}), "
            f"launches {b['launches']}")
        if b["err"] != 0.0 or not b["launches"]:
            raise AssertionError(f"{name}: {b}")
    res["wall_s"] = time.time() - t_phase
    log(f"phase ssaa2: {res['wall_s']:.1f} s")
    return res


def workspace_phase(cr, keep, scene, dev):
    """The workspace check: after phase ssaa2 grew the split walk's
    workspace, a 1080p renderer captured before the growth (its graph
    holds the older workspace tensors) replays its frame at the same
    orbit pose byte-equal to its frame from before the growth."""
    import bench_torch

    r, ws_img, caps = keep
    old = r._programs.progs["frame"].workspace
    if len(old) != 2:
        raise AssertionError("the captured frame program kept no workspace")
    now = cr.workspace_tensors(dev)
    orbit = bench_torch.Orbit(scene.camera)
    try:
        img = r.render(orbit.vp(WS_POSE))[0].cpu()
    finally:
        orbit.restore()
    res = {"old_workspace_bytes": sum(t.numel() * t.element_size()
                                      for t in old),
           "workspace_bytes": cr.workspace_bytes(),
           "grown": old[0].data_ptr() != now[0].data_ptr(),
           "recaptures": r.program_counts["frame_captures"] - caps,
           "equal": torch.equal(img, ws_img)}
    log(f"phase workspace: {res}")
    if not (res["grown"] and res["equal"]) or res["recaptures"]:
        raise AssertionError(f"workspace check: {res}")
    return res


def aniso_bound(args, spec, caps, seg_w: int):
    """The least time the card could take for one tiered sampler launch
    on ``args``: (ms, bytes, bilinear taps). Bytes: the per-pixel planes
    read once (uv and its two derivatives, 24 B; six int32 planes a slot,
    24 B), each slot's rgba written once (16 B), and one 2x2 block (16 B
    u8, 32 B u16) for every bilinear tap actually taken: two a trilinear
    tap, one trilinear tap a pixel and slot at the isotropic lod, and
    clamp(n, 1, taps_s) more where the pixel's row segment is selected
    for its tier (``sampling.aniso_slots``'s selection, recomputed)."""
    from renderengine_tpu_torch.shading import sampling

    atlas, _, _, slots, uv, dx, dy = args
    h, w = uv.shape[:2]
    ntx, _ = sampling.row_segments(h, w, seg_w)
    caps = caps or (spec.max_taps,) * len(slots)
    tri = len(slots) * h * w
    n, tiers = sampling.tier_selections(dx, dy, spec, seg_w)
    for taps, member, sel, _ in tiers:
        have = torch.zeros((h, ntx), dtype=torch.bool, device=n.device)
        have.scatter_(1, sel, True)
        have = have.repeat_interleave(seg_w, 1)[:, :w]
        for c in caps:
            taps_s = min(taps, c)
            if taps_s > 1:
                tri += int(n.clamp(1.0, float(taps_s))[member & have].sum())
    taps = 2 * tri
    bytes_moved = (h * w * 24 + len(slots) * h * w * (24 + 16)
                   + taps * 4 * atlas.shape[3])
    return bytes_moved / HBM_BYTES_PER_S * 1e3, bytes_moved, taps


def aniso_phase(fr, cr, scene, pp_cfg, dev, reset_counts):
    """Phase aniso: the tiered anisotropic sampler's kernel at the main
    path's shapes. The per-pixel default at 1080p settles over the orbit's
    first ``ANISO_SETTLE`` frames through the controller and the captured
    frame (as the benchmark's pp.orbit does), renders pose ``ANISO_POSE``,
    and its eager frame there records the sampler's calls: the opaque
    layer's full frame and the first peel layer shaded on its 128-wide
    pseudo-image (under the full-frame budget the controller chose). Each call's kernel equals the plain
    version bit for bit and is timed (CUDA-event median of 3 rounds of 30,
    in a graph, the profiler's device time, the host time a call) beside
    its bound (``aniso_bound``) and the plain version's time. Returns the
    two kernel rows and the phase's record."""
    import bench_torch
    from renderengine_tpu_torch.shading import sampling

    t_phase = time.time()
    orbit = bench_torch.Orbit(scene.camera)
    rows, res = [], {}
    try:
        r = fr.FrameRenderer(scene, pp_cfg)
        reset_counts()
        p0 = dict(r.program_counts)
        for i in range(ANISO_SETTLE):
            r.render(orbit.vp(i))
        r.render(orbit.vp(ANISO_POSE))
        torch.cuda.synchronize()
        launches = cr.launch_counts["aniso_slots"]
        caps = counts_delta(p0, r.program_counts)
        # a replay and a capture's warm-up frame each run the frame
        frames = caps["frame_replays"] + caps["frame_captures"]
        res.update({"launches": launches, "frames": frames,
                    "programs": caps,
                    "blend_layer_tile_budgets":
                        list(r.config.blend_layer_tile_budgets)})
        if launches != 3 * frames:
            raise AssertionError(f"aniso: {launches} launches over "
                                 f"{frames} frames, not 3 a frame")
        r._react_overflow = False
        calls = []
        real = sampling.sample_slots_aniso_tiered

        def record(*a, **k):
            calls.append((a, k))
            return real(*a, **k)

        with mock.patch.object(sampling, "sample_slots_aniso_tiered",
                               record):
            r.render_eager()
        torch.cuda.synchronize()
        # the opaque call, and the first peel layer shaded on its
        # compacted pseudo-image (a layer at the full-frame budget is
        # shaded dense)
        peel = [c for c in calls[1:]
                if c[0][4].shape[1] != calls[0][0][4].shape[1]]
        if len(calls) != 3 or not peel:
            raise AssertionError(f"aniso: {len(calls)} sampler calls, "
                                 f"none of them a pseudo-image")
        for name, (a, k) in (("aniso_slots", calls[0]),
                             ("aniso_slots_peel", peel[0])):
            atlas, mip_y, mip_x, slots, uv, dx, dy, spec = a
            caps, seg_w = k.get("slot_caps"), k.get("seg_w", 128)
            slots = [({key: tex[key].contiguous()
                       for key in sampling._PLANE_KEYS}, nm.contiguous())
                     for tex, nm in slots]
            args = (atlas, mip_y, mip_x, slots, uv.contiguous(),
                    dx.contiguous(), dy.contiguous())

            def kern(args=args, spec=spec, caps=caps, seg_w=seg_w):
                return sampling.aniso_slots(*args, spec, slot_caps=caps,
                                            seg_w=seg_w)

            got = kern()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            want = sampling.sample_slots_aniso_tiered_plain(
                *args, spec, slot_caps=caps, seg_w=seg_w)
            t1.record()
            torch.cuda.synchronize()
            plain_ms = t0.elapsed_time(t1)
            exact = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                        for x, y in zip(got, want))
            err = max(max_abs_err(x, y) for x, y in zip(got, want))
            log(f"  aniso vs plain [{name}, {tuple(uv.shape[:2])}, "
                f"{len(slots)} slots]: exact={exact}, max_abs_err={err!r}")
            if not exact:
                raise AssertionError(f"aniso_slots disagrees ({name})")
            rounds = [cuda_ms(kern, 30) for _ in range(3)]
            bound_ms, bytes_moved, taps = aniso_bound(args, spec, caps,
                                                      seg_w)
            t = {"ms": statistics.median(rounds), "rounds_ms": rounds,
                 "in_graph_ms": graph_ms(kern, 30),
                 "device_ms": device_ms(kern, 10,
                                        kernels=("aniso_slots_kernel",)),
                 "host_ms": host_ms(kern, 30)}
            log(f"  times [{name}]: {t}")
            rows.append({
                "name": name, "route": "cuda", "source": ANISO_SOURCE,
                "replaces": None, "launches": launches,
                "max_abs_err": err, "ms": t["ms"], "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": "bytes",
                "library_ms": None, "in_graph_ms": t["in_graph_ms"],
                "densest_tile_ms": None, "launch_over_densest": None,
                "device_ms": t["device_ms"], "host_ms": t["host_ms"],
                "pairs": None})
            res[name] = {"shape": list(uv.shape[:2]), "slots": len(slots),
                         "bytes": bytes_moved, "bilinear_taps": taps,
                         "rounds_ms": rounds}
            del got, want
        del r, calls
        torch.cuda.empty_cache()
    finally:
        orbit.restore()
    res["wall_s"] = time.time() - t_phase
    log(f"phase aniso: {res}")
    return rows, res


def tss_peel_bound(rgb, layers, factor: bool):
    """The least time the card could take for one peel-pass launch: (ms,
    bytes, covered layer pixels). Bytes: the planes read (both layers'
    tri ids at every pixel; a covered layer pixel's chart uv, and its
    material id with the factor alpha), the colour read and written once
    (24 B a pixel), and 20 B a covered layer pixel (its 16-byte rgb9e5
    block and 4-byte alpha block; 16 + 2 with the f16 factor alpha)."""
    h, w = rgb.shape[:2]
    covered = sum(int((layer[0] >= 0).sum()) for layer in layers)
    per_covered = 8 + (4 + 16 + 2 if factor else 20)
    bytes_moved = h * w * (8 + 24) + covered * per_covered
    return bytes_moved / HBM_BYTES_PER_S * 1e3, bytes_moved, covered


def tss_call_at_pose(fr, cr, scene, cfg, orbit, reset_counts, counter,
                     wrapper, plain, copy=lambda a, kw: (a, kw)):
    """A headline renderer of ``cfg`` over ``PEEL_FRAMES`` orbit frames and
    then ``PEEL_POSE``, through the controller and the captured frame: one
    ``counter`` launch a frame, replays included. Its eager frame's calls
    of ``lightchart.<wrapper>`` are recorded (``copy`` of each call's
    (args, kwargs) as it entered), and the eager frame with ``plain`` in
    the kernel's place is rendered: both must equal the replayed frame
    byte for byte. Returns (record, the calls, the settling frames'
    stats)."""
    from renderengine_tpu_torch.shading import lightchart as lc

    r = fr.FrameRenderer(scene, cfg)
    reset_counts()
    p0 = dict(r.program_counts)
    stats = [r.render(orbit.vp(i))[1] for i in range(PEEL_FRAMES)]
    img, _ = r.render(orbit.vp(PEEL_POSE))
    torch.cuda.synchronize()
    launches = cr.launch_counts[counter]
    caps = counts_delta(p0, r.program_counts)
    frames = caps["frame_replays"] + caps["frame_captures"]
    dropped = sum(any(int(v) for k, v in st.items() if "overflow" in k)
                  for st in stats[1:])
    rec = {"launches": launches, "frames": frames, "programs": caps,
           "frames_dropping_work": dropped}
    if launches != frames:
        raise AssertionError(f"{counter}: {rec}")
    r._react_overflow = False
    calls = []
    real = getattr(lc, wrapper)

    def record(*a, **kw):
        calls.append(copy(a, kw))
        return real(*a, **kw)

    with mock.patch.object(lc, wrapper, record):
        eager, _ = r.render_eager()
    with mock.patch.object(lc, wrapper, plain):
        plain_img, _ = r.render_eager()
    torch.cuda.synchronize()
    if len(calls) != 1 or not torch.equal(eager, img) or \
            not torch.equal(plain_img, img):
        raise AssertionError(f"{counter}: {len(calls)} calls; replay, "
                             f"eager and plain frames equal: "
                             f"{torch.equal(eager, img)}, "
                             f"{torch.equal(plain_img, img)}")
    return rec, calls, stats


def replayed_exact(kern, prepare, want_fn) -> bool:
    """``kern`` (a wrapper call returning its output) captured alone in a
    CUDA graph and replayed after ``prepare()``: its output bit for bit
    against ``want_fn()``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kern()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = kern()
    torch.cuda.current_stream().wait_stream(side)
    prepare()
    graph.replay()
    want = want_fn()
    torch.cuda.synchronize()
    return torch.equal(out.view(torch.int32), want.view(torch.int32))


def timed_row(name, source, kernel, kern, plain, launches, err, bound_ms):
    """A kernel row of a call: ``plain`` once (CUDA events), ``kern`` in 3
    rounds of 30 (the median), in a graph, the profiler's device time of
    ``kernel`` and the host time a call. Returns (row, rounds)."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    plain()
    t1.record()
    torch.cuda.synchronize()
    plain_ms = t0.elapsed_time(t1)
    rounds = [cuda_ms(kern, 30) for _ in range(3)]
    t = {"ms": statistics.median(rounds), "rounds_ms": rounds,
         "in_graph_ms": graph_ms(kern, 30),
         "device_ms": device_ms(kern, 10, kernels=(kernel,)),
         "host_ms": host_ms(kern, 30)}
    log(f"  times [{name}]: {t}")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": None, "launches": launches, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None,
            "in_graph_ms": t["in_graph_ms"], "densest_tile_ms": None,
            "launch_over_densest": None, "device_ms": t["device_ms"],
            "host_ms": t["host_ms"], "pairs": None}, rounds


def tss_peel_phase(fr, cr, scene, tss_cfg, dev, reset_counts):
    """Phase tss-peel: the texture-space peel pass's kernel at the
    headline's shapes. The 1080p headline and its ``ssaa=2`` twin
    (3840x2160 inside) each render ``PEEL_POSE`` of the orbit after
    ``PEEL_FRAMES`` orbit frames through the controller and the captured
    frame (one peel launch a frame, replays included, no observed shade
    tiles, nothing dropped); the eager frame's call is held bit for bit
    against the plain version, eager, on a row band (rows 536 on) and
    replayed from a CUDA graph, and timed (CUDA-event median of 3 rounds
    of 30, in a graph, the profiler's device time, the host time a call)
    beside its bound (``tss_peel_bound``) and the plain version's time.
    The frame with the plain version in the kernel's place is the same,
    byte for byte. Returns the two kernel rows and the phase's record."""
    import bench_torch
    from renderengine_tpu_torch.shading import lightchart as lc

    def copy(a, kw):
        rgb, rb, ab, layers, ah, aw = a[:6]
        mat = a[6] if len(a) > 6 else kw.get("mat_all")
        return (rgb.clone(), rb, ab,
                [tuple(t.clone() for t in la) for la in layers], ah, aw, mat)

    t_phase = time.time()
    orbit = bench_torch.Orbit(scene.camera)
    rows, res = [], {}
    try:
        for name, cfg in (("tss_peel", tss_cfg),
                          ("tss_peel_4k", tss_cfg.replace(ssaa=2))):
            rec, calls, stats = tss_call_at_pose(
                fr, cr, scene, cfg, orbit, reset_counts, "tss_peel",
                "tss_peel_composite", lc.tss_peel_composite_plain, copy)
            shade_tiles = sum("blend_shade_tiles" in st for st in stats)
            rec["frames_with_shade_tiles"] = shade_tiles
            if shade_tiles:
                raise AssertionError(f"{name}: {rec}")
            rgb, rb, ab, layers, ah, aw, mat = calls[0]
            band = [tuple(t[536:].contiguous() for t in la) for la in layers]
            exact, err = True, 0.0
            for args in ((rgb, layers), (rgb[536:].contiguous(), band)):
                got = lc.tss_peel_composite(args[0].clone(), rb, ab,
                                            args[1], ah, aw, mat)
                want = lc.tss_peel_composite_plain(args[0].clone(), rb, ab,
                                                   args[1], ah, aw, mat)
                exact &= torch.equal(got.view(torch.int32),
                                     want.view(torch.int32))
                err = max(err, max_abs_err(got, want))
            buf = rgb.clone()

            def kern(buf=buf, rb=rb, ab=ab, layers=layers, ah=ah, aw=aw,
                     mat=mat):
                return lc.tss_peel_composite(buf, rb, ab, layers, ah, aw,
                                             mat)

            def plain(rgb=rgb, rb=rb, ab=ab, layers=layers, ah=ah, aw=aw,
                      mat=mat):
                return lc.tss_peel_composite_plain(rgb.clone(), rb, ab,
                                                   layers, ah, aw, mat)

            exact &= replayed_exact(kern, lambda: buf.copy_(rgb), plain)
            log(f"  tss_peel vs plain [{name}, {tuple(rgb.shape[:2])}, "
                f"factor alpha {mat is not None}]: eager, band and replayed "
                f"exact={exact}, max_abs_err={err!r}")
            if not exact:
                raise AssertionError(f"tss_peel disagrees ({name})")
            bound_ms, bytes_moved, covered = tss_peel_bound(
                rgb, layers, mat is not None)
            row, rounds = timed_row(name, PEEL_SOURCE, "tss_peel_kernel",
                                    kern, plain, rec["launches"], err,
                                    bound_ms)
            rows.append(row)
            rec.update({"shape": list(rgb.shape[:2]), "bytes": bytes_moved,
                        "covered_layer_pixels": covered,
                        "factor_alpha": mat is not None,
                        "rounds_ms": rounds})
            res[name] = rec
            del calls, rgb, layers, band, buf, want
            torch.cuda.empty_cache()
    finally:
        orbit.restore()
    res["wall_s"] = time.time() - t_phase
    log(f"phase tss-peel: {res}")
    return rows, res


def tss_shade_bound(args):
    """The least time the card could take for one launch of the factored
    screen pass at the headline's settings (one dithered tap a pixel with
    a base texture): (ms, bytes, pixels with a base texture). Bytes: the
    pixel's chart uv, uv, material id and coverage read once (21 B), its
    rgba written once (16 B), one 32-byte light row a half-grid site, and
    the tap's 2x2 block (16 B for a u8 atlas, 32 B for u16) at every pixel
    whose material has a base texture; the material rows stay in cache."""
    scene, chart_uv, _, mat_id, _, _, _, _ = args
    h, w = chart_uv.shape[:2]
    n_mat = scene["mat_all"].shape[0]
    m = torch.where(mat_id < 0, mat_id + n_mat, mat_id).long()
    textured = int((scene["mat_all"][m, 16] >= 0).sum())
    block = 4 * scene["atlas"].shape[3]
    bytes_moved = (h * w * (21 + 16) + ((h + 1) // 2) * ((w + 1) // 2) * 32
                   + textured * block)
    return bytes_moved / HBM_BYTES_PER_S * 1e3, bytes_moved, textured


def tss_shade_phase(fr, cr, scene, tss_cfg, dev, reset_counts):
    """Phase tss-shade: the factored texture-space screen pass's kernel at
    the headline's shapes. The 1080p headline and its ``ssaa=2`` twin
    (3840x2160 inside) each render ``PEEL_POSE`` of the orbit after
    ``PEEL_FRAMES`` orbit frames through the controller and the captured
    frame (one screen-pass launch a frame, replays included); the eager
    frame's call is held bit for bit against the plain version, eager, on
    a row band starting on the odd row 537 and replayed from a CUDA graph,
    and timed (CUDA-event median of 3 rounds of 30, in a graph, the
    profiler's device time, the host time a call) beside its bound
    (``tss_shade_bound``) and the plain version's time. The frame with the
    plain version in the kernel's place is the same, byte for byte.
    Returns the two kernel rows and the phase's record."""
    import bench_torch
    from renderengine_tpu_torch.shading import lightchart as lc

    t_phase = time.time()
    orbit = bench_torch.Orbit(scene.camera)
    rows, res = [], {}
    try:
        for name, cfg in (("tss_shade", tss_cfg),
                          ("tss_shade_4k", tss_cfg.replace(ssaa=2))):
            rec, calls, _ = tss_call_at_pose(
                fr, cr, scene, cfg, orbit, reset_counts, "tss_shade",
                "tss_shade_halfres", lc.tss_shade_halfres_plain)
            a, kw = calls[0]
            cov = kw.pop("covered")
            sc, cu, uv, mat, l8, ah, aw = a
            rows_b = slice(537, 537 + 542)
            band = (sc, cu[rows_b], uv[rows_b], mat[rows_b], l8, ah, aw)
            exact, err = True, 0.0
            for call, ckw in ((a, dict(kw, covered=cov)),
                              (band, dict(kw, covered=cov[rows_b], y0=537))):
                got = lc.tss_shade_halfres(*call, **ckw)
                want = lc.tss_shade_halfres_plain(*call, **ckw)
                exact &= torch.equal(got.view(torch.int32),
                                     want.view(torch.int32))
                err = max(err, max_abs_err(got, want))

            def kern(a=a, kw=kw, cov=cov):
                return lc.tss_shade_halfres(*a, covered=cov, **kw)

            def plain(a=a, kw=kw, cov=cov):
                return lc.tss_shade_halfres_plain(*a, covered=cov, **kw)

            exact &= replayed_exact(kern, lambda: None, plain)
            log(f"  tss_shade vs plain [{name}, {tuple(cu.shape[:2])}]: "
                f"eager, band and replayed exact={exact}, "
                f"max_abs_err={err!r}")
            if not exact:
                raise AssertionError(f"tss_shade disagrees ({name})")
            bound_ms, bytes_moved, textured = tss_shade_bound((*a, cov))
            row, rounds = timed_row(name, SHADE_SOURCE, "tss_shade_kernel",
                                    kern, plain, rec["launches"], err,
                                    bound_ms)
            rows.append(row)
            rec.update({"shape": list(cu.shape[:2]), "bytes": bytes_moved,
                        "textured_pixels": textured, "rounds_ms": rounds})
            res[name] = rec
            del calls, a, band, got, want
            torch.cuda.empty_cache()
    finally:
        orbit.restore()
    res["wall_s"] = time.time() - t_phase
    log(f"phase tss-shade: {res}")
    return rows, res


CUBE_FACES = ("+X", "-X", "+Y", "-Y", "+Z", "-Z")


def cube_face_phase(fr, cr, tss_cfg):
    """Phase k1-cube: the nave lamp's cube faces through K1 at the
    benchmark's ``sponza1080_tss_cube`` shapes. The headline renderer over
    ``sponza_cube_scene`` renders its first frame and 3 shadow-dirty ones
    (replays of the shadow program: 8 depth-only K1 launches each, 6 of
    them the faces, read from K1's own ``variant_counts``; no pair
    dropped); then at the last
    frame's transforms each face's launch is held bit for bit against its
    plain version and timed (``time_shape``) beside its bound
    (``k1_bound``). Returns the kernel row of the densest face (the most
    pairs) and the phase's record (every face's numbers)."""
    from renderengine_tpu_torch.scene import procedural

    t_phase = time.time()
    r = fr.FrameRenderer(procedural.sponza_cube_scene(
        width=SPONZA_W, height=SPONZA_H), tss_cfg)
    (base,) = r._cube_bases
    r.render()
    torch.cuda.synchronize()
    before = cr.variant_counts[(0, False, False)]
    pc = r.program_counts
    passes = pc["shadow_replays"] + pc["shadow_captures"]
    for _ in range(3):
        r.mark_shadows_dirty()
        r.render()
    torch.cuda.synchronize()
    launches = cr.variant_counts[(0, False, False)] - before
    res = {"n_maps": r.n_shadows, "cube_base": base,
           "shadow_budget": r._shadow_budget_val,
           "shadow_overflow": r.shadow_overflow,
           "depth_launches": launches,
           "shadow_passes": (pc["shadow_replays"] + pc["shadow_captures"]
                             - passes),
           "faces": {}}
    # each replay, and each capture's warm-up, renders the 8 maps
    if (r.shadow_overflow or res["shadow_passes"] < 3
            or launches != r.n_shadows * res["shadow_passes"]):
        raise AssertionError(f"cube shadow frames: {res}")
    e = r.config.shadow_extent
    ntx = -(-e // cr.TILE_W)
    svp = fr.unpack_params(r._u, r.n_shadows)["shadow_viewproj"]
    rows = {}
    for f, name in enumerate(CUBE_FACES):
        s = fr.shadow_setup(r.scene_dev, svp[base + f], e)
        prep = cr.prepare_pairs(s, e, e, max_pairs=r._shadow_budget_val)
        if int(prep.bins.n_overflow):
            raise AssertionError(f"cube face {name}: pair overflow")
        err, st, plain_ms = k1_plain_check(cr, prep, ntx, e, e,
                                           f"cube face {name} {e}^2")
        if err != 0.0:
            raise AssertionError(f"cube face {name} is not bit-exact")
        b = prep.bins
        pairs, tiles = int(b.counts.sum()), int(b.counts.shape[0])
        args = (prep.pair_data, b.starts, b.counts, ntx, e, e)
        (solo,) = solo_counts(b.counts)
        solo_args = args[:2] + (solo,) + args[3:]
        t = time_shape(f"cube face {name}",
                       lambda: cr.raster_tiles(*args, n_attrs=0),
                       lambda: cr.raster_tiles(*solo_args, n_attrs=0))
        bound_ms, by, ops, nbytes = k1_bound(
            pairs, tiles, prep.pair_data.shape[1], 0, st["wins"])
        res["faces"][name] = {"pairs": pairs, "wins": st["wins"],
                              "max_per_tile": int(b.counts.max()),
                              "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": by, "ops": ops, "bytes": nbytes,
                              **t}
        log(f"phase k1-cube: face {name}: {pairs} pairs, {st['wins']} depth "
            f"wins; K1 {t['ms']:.4f} ms, device {t['device_ms']!r} ms, "
            f"bound {bound_ms:.4f} ms ({by})")
        rows[name] = {
            "name": "raster_tile_cube_face", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES, "launches": launches,
            "max_abs_err": err, "ms": t["ms"], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
            "in_graph_ms": t["in_graph_ms"],
            "densest_tile_ms": t["densest_tile_ms"],
            "launch_over_densest": t["launch_over_densest"],
            "device_ms": t["device_ms"], "host_ms": t["host_ms"],
            "pairs": pairs}
        del prep, s, args, solo_args
    del r
    torch.cuda.empty_cache()
    res["densest"] = max(rows, key=lambda n: rows[n]["pairs"])
    res["wall_s"] = time.time() - t_phase
    log(f"phase k1-cube: {json.dumps(res)}")
    return [rows[res["densest"]]], res


def cube_face_main() -> None:
    """Phase k1-cube alone: build the kernels, run ``cube_face_phase`` on
    the headline configuration, print the card and the kernel row."""
    from renderengine_tpu_torch.core.config import RenderConfig
    from renderengine_tpu_torch.graph import frame as fr
    from renderengine_tpu_torch.raster import cuda_raster as cr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cr.build()
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    try:
        rows, _ = cube_face_phase(fr, cr, RenderConfig(
            width=SPONZA_W, height=SPONZA_H, shadow_extent=4096,
            debug_views=False, texture_space=True, tss_preshaded_blend=True,
            dither_trilinear=True, sky_halfres=True))
    except Exception as e:  # noqa: BLE001 — the phase is fatal
        fail("k1-cube", e)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    dev = torch.device("cuda")
    t_start = time.time()

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # phase 1: build every kernel of the main path from the checkout
    phase = "build"
    try:
        from renderengine_tpu_torch.core.config import RenderConfig
        from renderengine_tpu_torch.graph import frame as fr
        from renderengine_tpu_torch.raster import binning
        from renderengine_tpu_torch.raster import cuda_raster as cr
        from renderengine_tpu_torch.raster.setup import (restrict_rows,
                                                         triangle_setup)
        from renderengine_tpu_torch.scene import procedural
        from renderengine_tpu_torch.tools import goldens
        from renderengine_tpu_torch.shading import lightchart
        t0 = time.time()
        so = cr.build()
        log(f"phase build: {so.name} in {time.time() - t0:.1f} s, "
            f"{cr._library().item_pairs} pairs per work item")
        for ln in so.with_suffix(".log").read_text().splitlines():
            if "Compiling entry" in ln:
                log(f"  ptxas: {ln.split(chr(39))[1][:100]}")
            if "registers" in ln or "spill" in ln:
                log(f"  ptxas: {ln.strip()}")
    except Exception as e:  # noqa: BLE001 — every phase is fatal
        fail(phase, e)

    def reset_counts():
        for counts in (cr.launch_counts, cr.helper_counts):
            for k in counts:
                counts[k] = 0
        cr.variant_counts.clear()

    # phase 2: K1 against its plain version on random triangles, in every
    # mode: single winner, peel, dual, each on the dense and a sparse grid
    phase = "k1-random"
    max_err = {"opaque": 0.0, "shadow": 0.0, "peel2": 0.0, "tss": 0.0,
               "tss_peel2": 0.0, "k2_2": 0.0, "k2_4": 0.0}
    try:
        rng = np.random.default_rng(0)
        for (w, h, cull, n) in ((64, 48, 0, 16), (53, 37, 1, 12),
                                (97, 61, 0, 60)):
            scale = rng.uniform(0.02, 1.0, (n, 1, 1)).astype(np.float32)
            center = rng.uniform(-1.1, 1.1, (n, 1, 2)).astype(np.float32)
            tri = center + scale * rng.uniform(-1, 1, (n, 3, 2)).astype(
                np.float32)
            z = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
            clip = np.concatenate([tri, z[..., None],
                                   np.ones((n, 3, 1), np.float32)], -1)
            vidx = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
            s = triangle_setup(torch.from_numpy(clip.reshape(-1, 4)).to(dev),
                               torch.from_numpy(vidx).to(dev), n, w, h, cull)
            ntx, nty = -(-w // cr.TILE_W), -(-h // cr.TILE_H)
            for n_attrs in (0, 4, 8):
                ap = None
                if n_attrs:
                    ap = cr.attribute_planes(s, torch.from_numpy(
                        rng.uniform(-5, 5, (n, 3, n_attrs)).astype(
                            np.float32)).to(dev))
                prep = cr.prepare_pairs(
                    s, h, w, max_pairs=8192, attr_planes=ap,
                    tri_mat=torch.arange(n, device=dev, dtype=torch.int32) % 5)
                # peel bounds: past the nearest layer, under a far bound
                g = cr.rasterize_cuda(s, h, w, prepared=prep)
                g = g[0] if n_attrs else g
                far = torch.full((h, w), 0.8, device=dev)
                front = torch.full((h, w), -1.0, device=dev)
                behind = torch.where(g.tri_id >= 0, g.depth, 2.0)
                covered = int((prep.bins.counts > 0).sum())
                sparse = cr.sparse_tile_map(prep.bins.counts,
                                            max(1, covered - 1))
                for mode, pb, dual in (("single", None, False),
                                       ("peel", (behind, far), False),
                                       ("dual", (front, far), True)):
                    bounds = (None if pb is None else
                              cr._tile_bounds(pb, h, w, nty, ntx))
                    for tile_map in (None, sparse):
                        err, _, _ = k1_plain_check(
                            cr, prep, ntx, w, h,
                            f"random {w}x{h} cull={cull} n_attrs={n_attrs} "
                            f"{mode}{'' if tile_map is None else ' sparse'}",
                            bounds, tile_map, dual)
                        key = ("peel2" if dual else
                               "opaque" if n_attrs else "shadow")
                        if n_attrs == 4:
                            key = "tss_peel2" if dual else "tss"
                        max_err[key] = max(max_err[key], err)
    except Exception as e:  # noqa: BLE001
        fail(phase, e)

    # phase 2b: K2 against its plain version and against the separate K1
    # launches on random triangles: an opaque and a translucent table of 4
    # attributes, 2 or 4 blend attributes
    phase = "k2-random"
    try:
        rng = np.random.default_rng(1)
        for (w, h, cull, n) in ((64, 48, 1, 16), (53, 37, 0, 24),
                                (97, 61, 1, 60)):
            preps = []
            for c in (cull, 0):
                scale = rng.uniform(0.05, 1.0, (n, 1, 1)).astype(np.float32)
                center = rng.uniform(-1.1, 1.1, (n, 1, 2)).astype(np.float32)
                tri = center + scale * rng.uniform(-1, 1, (n, 3, 2)).astype(
                    np.float32)
                z = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
                clip = np.concatenate([tri, z[..., None],
                                       np.ones((n, 3, 1), np.float32)], -1)
                vidx = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
                s = triangle_setup(
                    torch.from_numpy(clip.reshape(-1, 4)).to(dev),
                    torch.from_numpy(vidx).to(dev), n, w, h, c)
                ap = cr.attribute_planes(s, torch.from_numpy(
                    rng.uniform(-5, 5, (n, 3, 4)).astype(np.float32)).to(dev))
                preps.append(cr.prepare_pairs(
                    s, h, w, max_pairs=8192, attr_planes=ap,
                    tri_mat=torch.arange(n, device=dev,
                                         dtype=torch.int32) % 7))
            for nab in (2, 4):
                err, _, _ = k2_check(cr, preps[0], preps[1],
                                     -(-w // cr.TILE_W), w, h, nab,
                                     f"random {w}x{h} cull={cull} "
                                     f"n_attrs_b={nab}")
                max_err[f"k2_{nab}"] = max(max_err[f"k2_{nab}"], err)
    except Exception as e:  # noqa: BLE001
        fail(phase, e)

    # phase 2c: the dense-tile stress scene through both kernels: one tile
    # of at least 8 work items, ties (duplicated triangles, -0.0 and
    # depth-1.0 fragments, peel bounds equal to fragment depths), every K1
    # mode on the dense and the sparse grid and a row slice; K2 at 2 and 4
    # blend attributes. Everything bit-exact, signs of zero included.
    phase = "split-stress"
    try:
        from renderengine_tpu_torch.tools import split_stress as ss
        item = cr._library().item_pairs
        n_dense = 8 * item + 64
        s_ntx = ss.WIDTH // cr.TILE_W
        n_checked = 0

        def same(a, b):
            return torch.equal(a, b) and torch.equal(torch.signbit(a),
                                                     torch.signbit(b))

        for n_attrs in (0, 4, 8):
            for y0, sh in ((0, None), (8, 32)):
                prep = ss.stress_pairs(0, n_attrs, n_dense=n_dense, y0=y0,
                                       slice_h=sh, device=dev)
                b = prep.bins
                _, count = ss.densest_tile(prep)
                if count <= 8 * item:
                    raise AssertionError(f"stress tile of {count} pairs")
                bds = ss.stress_bounds(prep, y0)
                sparse = cr.sparse_tile_map(
                    b.counts, max(1, int((b.counts > 0).sum()) - 1))
                for mode in ("single", "peel", "dual"):
                    for tile_map in (None, sparse):
                        args = (prep.pair_data, b.starts, b.counts, s_ntx,
                                ss.WIDTH, ss.HEIGHT, y0, n_attrs,
                                None if mode == "single" else bds[mode],
                                tile_map, mode == "dual")
                        if not same(cr.raster_tiles(*args),
                                    cr._raster_tiles_plain(*args)):
                            raise AssertionError(
                                f"K1 split walk differs: n_attrs {n_attrs}"
                                f" y0 {y0} {mode} sparse "
                                f"{tile_map is not None}")
                        n_checked += 1
        pa = ss.stress_pairs(0, 4, n_dense=n_dense, device=dev)
        pb = ss.stress_pairs(1, 4, n_dense=n_dense, device=dev)
        for nab in (2, 4):
            k2_check(cr, pa, pb, s_ntx, ss.WIDTH, ss.HEIGHT, nab,
                     f"split stress, n_attrs_b={nab}")
            tabs = (pa.pair_data, pa.bins.starts, pa.bins.counts,
                    pb.pair_data, pb.bins.starts, pb.bins.counts, s_ntx,
                    ss.WIDTH, ss.HEIGHT, 0, nab)
            if not same(cr.merged_tiles(*tabs),
                        cr._merged_tiles_plain(*tabs)):
                raise AssertionError("K2 split walk differs in a sign")
            n_checked += 1
        # a replayed launch starts from the counters the last one left: K2
        # captured once in a CUDA graph (on a side stream, whose first
        # launch is ordered after the default stream's), replayed in turns
        # with launches outside the graph
        want = cr._merged_tiles_plain(*tabs)
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            cr.merged_tiles(*tabs)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                replayed = cr.merged_tiles(*tabs)
        for _ in range(3):
            graph.replay()
            if not (same(replayed, want)
                    and same(cr.merged_tiles(*tabs), want)):
                raise AssertionError("a replayed K2 launch differs")
            n_checked += 2
        del graph, replayed
        log(f"phase split-stress: {n_checked} launches bit-exact (signs of "
            f"zero too), densest tile {count} pairs = "
            f"{-(-count // item)} work items of {item}")
    except Exception as e:  # noqa: BLE001
        fail(phase, e)

    # phase 3: golden configs at 128x96 through the entry point, on the card
    phase = "goldens"
    try:
        for name, factory, cfg in goldens.golden_cases():
            r = fr.FrameRenderer(factory(), cfg, device=dev, backend="cuda")
            img, st = r.render()
            frac, mx = goldens.golden_bar(img.cpu().numpy(),
                                          goldens.load_golden(name))
            over = {k: int(v) for k, v in st.items() if "overflow" in k}
            over["shadow_overflow"] = r.shadow_overflow
            log(f"phase goldens: {name}: {frac:.6f} within 1/255, "
                f"max {mx}/255, {over}")
            if not goldens.meets_bar(frac, mx):
                raise AssertionError(f"{name} misses the golden bar")
            if any(over.values()):
                raise AssertionError(f"{name}: overflow {over}")
    except Exception as e:  # noqa: BLE001
        fail(phase, e)

    # phase 4: the Sponza opaque pass at 1920x1080 — K1 vs plain, timings
    phase = "k1-sponza"
    try:
        t0 = time.time()
        scene = procedural.sponza_scene(width=SPONZA_W, height=SPONZA_H)
        cfg = RenderConfig(width=SPONZA_W, height=SPONZA_H, shadows=False,
                           skybox=False, translucency=False)
        opaque_renderer = fr.FrameRenderer(scene, cfg)   # cuda, backend cuda
        sd = opaque_renderer.scene_dev
        n_tris = int(sd["n_tris"])
        n_tex = int(sd["tex_table"].shape[0])
        atlas_mb = sd["atlas"].numel() * 4 / 1e6
        log(f"phase k1-sponza: scene {n_tris} tris, {n_tex} textures, "
            f"atlas {atlas_mb:.1f} MB, set-up {time.time() - t0:.1f} s; "
            f"pair budget {opaque_renderer.config.raster.pair_budget}, "
            f"dense_k {opaque_renderer.config.raster.dense_k}")
        u = torch.from_numpy(opaque_renderer.uniform_for_camera()).to(dev)
        params = fr.unpack_params(u, 0)
        setup = fr.opaque_setup(sd, params, opaque_renderer.config)
        prep = fr.opaque_pairs(sd, setup, opaque_renderer.config)
        ntx = -(-SPONZA_W // cr.TILE_W)
        nty = -(-SPONZA_H // cr.TILE_H)
        err, st_o, plain_ms = k1_plain_check(cr, prep, ntx, SPONZA_W,
                                             SPONZA_H,
                                             "sponza 1920x1080 opaque")
        max_err["opaque"] = max(max_err["opaque"], err)
        wins = st_o["wins"]
        b = prep.bins
        pairs = int(b.counts.sum())
        n_tiles = int(b.counts.shape[0])
        max_count = int(b.counts.max())
        args = (prep.pair_data, b.starts, b.counts, ntx, SPONZA_W, SPONZA_H)
        # the densest tile alone, in a launch of the same grid: before the
        # split walk, the serial floor of one block per tile
        (solo,) = solo_counts(b.counts)
        solo_args = (prep.pair_data, b.starts, solo, ntx, SPONZA_W, SPONZA_H)
        times = {"raster_tile": time_shape(
            "per-pixel opaque", lambda: cr.raster_tiles(*args, n_attrs=8),
            lambda: cr.raster_tiles(*solo_args, n_attrs=8))}
        k1_ms = times["raster_tile"]["ms"]
        densest_ms = times["raster_tile"]["densest_tile_ms"]
        bound_ms, bound_by, ops, bytes_moved = k1_bound(
            pairs, n_tiles, prep.pair_data.shape[1], 8, wins)
        log(f"phase k1-sponza: {pairs} pairs over {n_tiles} tiles (max "
            f"{max_count}/tile), {wins} depth wins; K1 {k1_ms:.4f} ms, "
            f"densest tile alone {densest_ms:.4f} ms, plain {plain_ms:.2f} "
            f"ms, bound {bound_ms:.4f} ms ({bound_by}: {ops:.3e} ops, "
            f"{bytes_moved:.3e} B)")
        opaque_depth = cr.rasterize_cuda(setup, SPONZA_H, SPONZA_W,
                                         prepared=prep)[0].depth
    except Exception as e:  # noqa: BLE001
        fail(phase, e)

    # phase 5: the opaque-only frame of the first slice, still driven once
    phase = "opaque-path"
    try:
        opaque_renderer.render()                         # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        img, stats = opaque_renderer.render()
        torch.cuda.synchronize()
        opaque_frame_ms = (time.perf_counter() - t0) * 1e3
        opaque_launches = cr.launch_counts["raster_tile"]
        log(f"phase opaque-path: launches {opaque_launches}, frame "
            f"{opaque_frame_ms:.1f} ms")
        if opaque_launches != 1:
            raise AssertionError("the opaque frame did not launch K1 once")
        if int(stats["pair_overflow"]) or int(stats["pair_tail_overflow"]):
            raise AssertionError("pair overflow on the opaque frame")
        if float((img[..., :3].amax(-1) > 0).float().mean()) < 0.5:
            raise AssertionError("the opaque frame is mostly empty")
        del opaque_renderer, img
    except Exception as e:  # noqa: BLE001
        fail(phase, e)

    # the default configuration: nothing switched off
    phase = "renderer"
    try:
        t0 = time.time()
        renderer = fr.FrameRenderer(
            scene, RenderConfig(width=SPONZA_W, height=SPONZA_H))
        rcfg = renderer.config
        sd = renderer.scene_dev
        n_maps = renderer.n_shadows
        log(f"phase renderer: default config set up in {time.time() - t0:.1f}"
            f" s; {n_maps} shadow maps of {rcfg.shadow_extent}^2, shadow pair"
            f" budget {renderer._shadow_budget_val}, blend pair budget "
            f"{rcfg.blend_pair_budget}, blend tile budget "
            f"{rcfg.blend_tile_budget}, shade tile fraction "
            f"{rcfg.translucency_tile_fraction:.4f}, penumbra tile budget "
            f"{rcfg.penumbra_tile_budget}")
        if n_maps < 1 or not renderer._has_translucent:
            raise AssertionError("the scene lacks shadow casters or blend "
                                 "geometry")
        u = torch.from_numpy(renderer.uniform_for_camera()).to(dev)
        params = fr.unpack_params(u, n_maps)
    except Exception as e:  # noqa: BLE001
        fail(phase, e)

    # phase 6: the sun's 4096^2 depth-only pass — K1 vs plain, timings
    phase = "k1-shadow"
    try:
        e_sh = rcfg.shadow_extent
        sun = int(sd["light_shadow_index"][
            (sd["light_type"] == 1).nonzero()[0, 0]])
        s_sh = fr.shadow_setup(sd, params["shadow_viewproj"][sun], e_sh)
        prep_sh = cr.prepare_pairs(s_sh, e_sh, e_sh,
                                   max_pairs=renderer._shadow_budget_val)
        if int(prep_sh.bins.n_overflow):
            raise AssertionError("shadow pair overflow")
        ntx_sh = -(-e_sh // cr.TILE_W)
        err, st_s, sh_plain_ms = k1_plain_check(
            cr, prep_sh, ntx_sh, e_sh, e_sh, f"sponza sun shadow {e_sh}^2")
        if err != 0.0:
            raise AssertionError("the shadow launch is not bit-exact")
        max_err["shadow"] = max(max_err["shadow"], err)
        bs = prep_sh.bins
        sh_pairs, sh_tiles = int(bs.counts.sum()), int(bs.counts.shape[0])
        sh_args = (prep_sh.pair_data, bs.starts, bs.counts, ntx_sh, e_sh,
                   e_sh)
        (sh_solo,) = solo_counts(bs.counts)
        sh_solo_args = sh_args[:2] + (sh_solo,) + sh_args[3:]
        times["raster_tile_shadow"] = time_shape(
            "shadow", lambda: cr.raster_tiles(*sh_args, n_attrs=0),
            lambda: cr.raster_tiles(*sh_solo_args, n_attrs=0))
        sh_ms = times["raster_tile_shadow"]["ms"]
        sh_bound_ms, sh_bound_by, sh_ops, sh_bytes = k1_bound(
            sh_pairs, sh_tiles, prep_sh.pair_data.shape[1], 0, st_s["wins"])
        log(f"phase k1-shadow: map {sun}: {sh_pairs} pairs over {sh_tiles} "
            f"tiles (max {int(bs.counts.max())}/tile), {st_s['wins']} depth "
            f"wins; K1 {sh_ms:.4f} ms, plain {sh_plain_ms:.2f} ms, bound "
            f"{sh_bound_ms:.4f} ms ({sh_bound_by}: {sh_ops:.3e} ops, "
            f"{sh_bytes:.3e} B)")
        del prep_sh, s_sh
    except Exception as e:  # noqa: BLE001
        fail(phase, e)

    # phase 6b: the apps' default 2048^2 depth-only pass of the same sun
    # (main_sample and live_viewer run --shadowExtent 2048) — K1 vs plain,
    # timings; phase app-path checks that the app launches this table
    phase = "k1-shadow-2048"
    try:
        e2, sun2 = 2048, sun
        s2 = fr.shadow_setup(sd, params["shadow_viewproj"][sun2], e2)
        # the (tile, triangle) spans bound the live pairs from above
        spans2 = int(binning._tile_spans(s2, cr.TILE_H, cr.TILE_W)[4].sum())
        prep2 = cr.prepare_pairs(s2, e2, e2, max_pairs=spans2 + 8192)
        if int(prep2.bins.n_overflow):
            raise AssertionError("2048^2 shadow pair overflow")
        ntx2 = -(-e2 // cr.TILE_W)
        err2, st2, sh2_plain_ms = k1_plain_check(
            cr, prep2, ntx2, e2, e2, f"sponza sun shadow {e2}^2")
        if err2 != 0.0:
            raise AssertionError(f"the {e2}^2 shadow launch is not "
                                 f"bit-exact")
        b2 = prep2.bins
        sh2_pairs, sh2_tiles = int(b2.counts.sum()), int(b2.counts.shape[0])
        sh2_args = (prep2.pair_data, b2.starts, b2.counts, ntx2, e2, e2)
        (sh2_solo,) = solo_counts(b2.counts)
        sh2_solo_args = sh2_args[:2] + (sh2_solo,) + sh2_args[3:]
        times["raster_tile_shadow_2048"] = time_shape(
            f"shadow {e2}^2", lambda: cr.raster_tiles(*sh2_args, n_attrs=0),
            lambda: cr.raster_tiles(*sh2_solo_args, n_attrs=0))
        sh2_ms = times["raster_tile_shadow_2048"]["ms"]
        sh2_bound_ms, sh2_bound_by, sh2_ops, sh2_bytes = k1_bound(
            sh2_pairs, sh2_tiles, prep2.pair_data.shape[1], 0, st2["wins"])
        log(f"phase k1-shadow-2048: map {sun2}: {sh2_pairs} pairs over "
            f"{sh2_tiles} tiles (max {int(b2.counts.max())}/tile), "
            f"{st2['wins']} depth wins; K1 {sh2_ms:.4f} ms, plain "
            f"{sh2_plain_ms:.2f} ms, bound {sh2_bound_ms:.4f} ms "
            f"({sh2_bound_by}: {sh2_ops:.3e} ops, {sh2_bytes:.3e} B)")
        sh2_live, sh2_counts = prep2.pair_data[b2.pair_valid], b2.counts
        del prep2, s2, sh2_args, sh2_solo_args
    except Exception as e:  # noqa: BLE001
        fail(phase, e)

    # phase 7: the 1080p blend list, dual + bounds (-1, opaque depth) on
    # the sparse grid at the renderer's tile budget — K1 vs plain, timings
    phase = "k1-peel"
    try:
        setup_t = fr.blend_setup(sd, params, rcfg)
        prep_t = fr.blend_pairs(sd, setup_t, rcfg)
        bt = prep_t.bins
        covered_tiles = int((bt.counts > 0).sum())
        if int(bt.n_overflow) or covered_tiles > rcfg.blend_tile_budget:
            raise AssertionError("blend pair or tile budget overflow")
        front = torch.full((SPONZA_H, SPONZA_W), -1.0, device=dev)
        bounds = cr._tile_bounds((front, opaque_depth), SPONZA_H, SPONZA_W,
                                 nty, ntx)
        # the grid the renderer's budget gives this launch: sparse when
        # the budget is below the tile count, else every tile
        tile_map = (cr.sparse_tile_map(bt.counts, rcfg.blend_tile_budget)
                    if rcfg.blend_tile_budget < n_tiles else None)
        n_sel = n_tiles if tile_map is None else int(tile_map.shape[0])
        err, st_p, pl_plain_ms = k1_plain_check(
            cr, prep_t, ntx, SPONZA_W, SPONZA_H,
            f"sponza 1920x1080 dual peel, {n_sel} of {n_tiles} tiles",
            bounds, tile_map, True)
        # and a grid that is sparse whatever the budget: half the covered
        # tiles, the rest dropped
        half = cr.sparse_tile_map(bt.counts, max(1, covered_tiles // 2))
        err_half, _, _ = k1_plain_check(
            cr, prep_t, ntx, SPONZA_W, SPONZA_H,
            f"sponza 1920x1080 dual peel, {int(half.shape[0])} of {n_tiles} "
            f"tiles", bounds, half, True)
        err = max(err, err_half)
        max_err["peel2"] = max(max_err["peel2"], err)
        pl_args = (prep_t.pair_data, bt.starts, bt.counts, ntx, SPONZA_W,
                   SPONZA_H, 0, 8, bounds, tile_map, True)
        (pl_solo,) = solo_counts(bt.counts)
        pl_solo_args = pl_args[:2] + (pl_solo,) + pl_args[3:]
        times["raster_tile_peel2"] = time_shape(
            "per-pixel dual peel", lambda: cr.raster_tiles(*pl_args),
            lambda: cr.raster_tiles(*pl_solo_args))
        pl_ms = times["raster_tile_peel2"]["ms"]
        pl_pairs = int(bt.counts.sum() if tile_map is None
                       else bt.counts[tile_map.long()].sum())
        pl_bound_ms, pl_bound_by, pl_ops, pl_bytes = k1_bound(
            pl_pairs, n_sel, prep_t.pair_data.shape[1], 8, st_p["wins"],
            st_p["demotes"], peel=True, dual=True,
            sparse=tile_map is not None)
        log(f"phase k1-peel: {pl_pairs} pairs over {n_sel} slots "
            f"({covered_tiles} covered tiles, max {int(bt.counts.max())}"
            f"/tile), {st_p['wins']} layer entries, {st_p['demotes']} "
            f"demotions; K1 {pl_ms:.4f} ms, plain {pl_plain_ms:.2f} ms, "
            f"bound {pl_bound_ms:.4f} ms ({pl_bound_by}: {pl_ops:.3e} ops, "
            f"{pl_bytes:.3e} B)")
        del prep_t, bounds
    except Exception as e:  # noqa: BLE001
        fail(phase, e)

    # phase 8: the main path, counted — FrameRenderer.render() x N_FRAMES
    # on the default configuration
    phase = "main-path"
    try:
        opaque_v, shadow_v, peel_v = ((8, False, False), (0, False, False),
                                      (8, True, True))
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        frame_ms, per_frame, helpers, main_caps = [], [], [], []
        for _ in range(N_FRAMES):
            before = dict(cr.variant_counts)
            h_before = dict(cr.helper_counts)
            p_before = dict(renderer.program_counts)
            t0 = time.perf_counter()
            img, stats = renderer.render()
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            per_frame.append({v: cr.variant_counts[v] - before.get(v, 0)
                              for v in (opaque_v, shadow_v, peel_v)})
            helpers.append({k: cr.helper_counts[k] - h_before[k]
                            for k in cr.helper_counts})
            main_caps.append(counts_delta(p_before,
                                          renderer.program_counts))
        total = cr.launch_counts["raster_tile"]
        launches = {v: cr.variant_counts[v]
                    for v in (opaque_v, shadow_v, peel_v)}
        mem = {"workspace_bytes": cr.workspace_bytes(),
               "peak_bytes": torch.cuda.max_memory_allocated()}
        log(f"phase main-path: {total} launches {per_frame}, workspace "
            f"zeroings {helpers}, frame ms {frame_ms} (one block per tile, warm: "
            f"{BEFORE_SPLIT_FRAME_MS['per_pixel']}); split-walk workspace "
            f"{mem['workspace_bytes']} B, peak device memory of the frames "
            f"{mem['peak_bytes']} B; captures and replays {main_caps}; "
            f"programs {renderer.program_stats()}")
        for i, pf in enumerate(per_frame):
            want = expected_launches({opaque_v: 1, peel_v: 1}, main_caps[i],
                                     n_maps, shadow_v)
            if main_caps[i]["frame_replays"] != 1:
                raise AssertionError(f"frame {i}: {main_caps[i]}")
            if {v: n for v, n in pf.items() if n} != want:
                raise AssertionError(f"frame {i}: K1 launches {pf}, "
                                     f"expected {want}")
            if helpers[i]["workspace_zero"] > sum(pf.values()):
                raise AssertionError(f"frame {i}: zeroings {helpers[i]}")
        if total != sum(launches.values()):
            raise AssertionError("a K1 launch of an unexpected shape")
        over = {k: int(v) for k, v in stats.items() if "overflow" in k}
        over["shadow_overflow"] = renderer.shadow_overflow
        extra = {k: v.tolist() for k, v in stats.items()
                 if "overflow" not in k}
        log(f"phase main-path: {over} {extra}; penumbra tile budget "
            f"{rcfg.penumbra_tile_budget} -> "
            f"{renderer.config.penumbra_tile_budget} after the first frame's "
            f"counters")
        rcfg = renderer.config
        need = {"pair_overflow", "pair_tail_overflow", "blend_pair_overflow",
                "shadow_overflow"}
        if rcfg.penumbra_tile_budget:
            need.add("penumbra_overflow")
        if any(over.values()) or set(over) != need:
            raise AssertionError(f"overflow counters {over}")
        img_np = img.cpu().numpy()
        if img_np.shape != (SPONZA_H, SPONZA_W, 4) or img_np.dtype != np.uint8:
            raise AssertionError(f"bad image {img_np.shape} {img_np.dtype}")
        # sky where the opaque pass left nothing (seen through the
        # translucent layers, which span this view): against the same frame
        # rendered with the skybox off, those pixels are never darker and
        # nearly all brighter, and every other pixel is identical
        prep = fr.opaque_pairs(sd, fr.opaque_setup(sd, params, rcfg), rcfg)
        open_px = cr.rasterize_cuda(None, SPONZA_H, SPONZA_W,
                                    prepared=prep)[0].tri_id < 0
        nosky, _ = fr.render_frame(
            sd, u, renderer._shadow_maps, rcfg.replace(skybox=False), n_maps,
            "cuda", True, renderer._slots_used,
            shadow_lights=renderer._shadow_lights,
            has_mask=renderer._has_mask)
        sky_share = float(open_px.float().mean())
        lit, dark = img[..., :3][open_px].int(), nosky[..., :3][open_px].int()
        never_darker = bool((lit >= dark).all())
        brighter = float((lit > dark).any(-1).float().mean())
        rest_same = bool((img[~open_px] == nosky[~open_px]).all())
        drawn = float((img[..., :3][~open_px].amax(-1) > 0).float().mean())
        log(f"phase main-path: sky on {sky_share:.4f} of the frame: never "
            f"darker than without the skybox {never_darker}, brighter on "
            f"{brighter:.4f} of it, other pixels identical {rest_same}; "
            f"{drawn:.4f} of the covered pixels lit")
        if not (0.001 < sky_share < 0.5 and never_darker and brighter > 0.9
                and rest_same and drawn > 0.9):
            raise AssertionError("sky or coverage check failed")
        del prep, nosky, lit, dark
        # the shadow cache: dirty -> the maps render again, once
        reset_counts()
        renderer.mark_shadows_dirty()
        img2, _ = renderer.render()
        renderer.render()
        torch.cuda.synchronize()
        if cr.variant_counts[shadow_v] != n_maps or renderer.shadow_overflow:
            raise AssertionError("mark_shadows_dirty() did not re-render the "
                                 f"{n_maps} maps once")
        frac, mx = goldens.golden_bar(img_np, img2.cpu().numpy())
        log(f"phase main-path: frame after mark_shadows_dirty() identical: "
            f"{torch.equal(img2, img)} ({frac:.6f} within 1/255, max {mx})")
        if not goldens.meets_bar(frac, mx):
            raise AssertionError("the re-rendered maps changed the frame")
        # the same frame with K1 swapped for its plain version on the card,
        # dispatched op by op (the cached shadow maps stay: phase k1-shadow
        # held that launch)
        with mock.patch.object(cr, "raster_tiles", cr._raster_tiles_plain):
            ref, _ = renderer.render_eager()
        frac, mx = goldens.golden_bar(img_np, ref.cpu().numpy())
        log(f"phase main-path: vs plain-K1 frame {frac:.6f} within 1/255, "
            f"max {mx}/255")
        if not goldens.meets_bar(frac, mx):
            raise AssertionError("K1 frame misses the bar against plain K1")
    except Exception as e:  # noqa: BLE001
        fail(phase, e)

    # phase: K1 on the lower band of the 1080p frame: the opaque pass at 8
    # attributes and the dual peel bounded by the band's opaque depth,
    # each against its plain version, first from the mid-tile row 540
    # (4 rows into an 8-row tile), then as the second of two ranks
    # launches them (its band [540, 1080) renders from row 536, the tile
    # row it starts in: sharded.band_extent), timed; then the single-card
    # frame the sharded phase is held to, with the renderer's settled
    # budgets (every counter 0)
    phase = "k1-band"
    try:
        from renderengine_tpu_torch.parallel import sharded

        ntx_b = -(-SPONZA_W // cr.TILE_W)
        y0m = SPONZA_H // 2
        prep_m = fr.opaque_pairs(sd, restrict_rows(fr.opaque_setup(
            sd, params, rcfg), y0m, y0m, SPONZA_H), rcfg, y0m, y0m)
        k1_plain_check(cr, prep_m, ntx_b, SPONZA_W, SPONZA_H,
                       f"per-pixel opaque y0={y0m} (mid-tile)", y0=y0m)
        depth_m = cr.raster_tiles(
            prep_m.pair_data, prep_m.bins.starts, prep_m.bins.counts, ntx_b,
            SPONZA_W, SPONZA_H, y0m, 8)[:, 0]
        prep_mt = fr.blend_pairs(sd, restrict_rows(fr.blend_setup(
            sd, params, rcfg), y0m, y0m, SPONZA_H), rcfg, y0m, y0m)
        k1_plain_check(cr, prep_mt, ntx_b, SPONZA_W, SPONZA_H,
                       f"per-pixel dual peel y0={y0m} (mid-tile)",
                       torch.stack([torch.full_like(depth_m, -1.0), depth_m],
                                   1).contiguous(), None, True, y0=y0m)
        del prep_m, prep_mt, depth_m
        y0b, ye_b = sharded.band_extent(rcfg, y0m, SPONZA_H - y0m)
        hsb = ye_b - y0b
        setup_ob = restrict_rows(fr.opaque_setup(sd, params, rcfg), y0b, hsb,
                                 SPONZA_H)
        prep_ob = fr.opaque_pairs(sd, setup_ob, rcfg, hsb, y0b)
        bo = prep_ob.bins
        err, st_ob, ob_plain_ms = k1_plain_check(
            cr, prep_ob, ntx_b, SPONZA_W, SPONZA_H,
            f"per-pixel opaque band y0={y0b}", y0=y0b)
        max_err["band_opaque"] = err
        ob_args = (prep_ob.pair_data, bo.starts, bo.counts, ntx_b, SPONZA_W,
                   SPONZA_H, y0b, 8)
        (ob_solo,) = solo_counts(bo.counts)
        times["raster_tile_band"] = time_shape(
            f"per-pixel opaque band y0={y0b}",
            lambda: cr.raster_tiles(*ob_args),
            lambda: cr.raster_tiles(*ob_args[:2], ob_solo, *ob_args[3:]))
        ob_pairs = int(bo.counts.sum())
        ob_tiles = int(bo.counts.shape[0])
        ob_bound = k1_bound(ob_pairs, ob_tiles, prep_ob.pair_data.shape[1], 8,
                            st_ob["wins"])
        band_depth = cr.raster_tiles(*ob_args)[:, 0]
        setup_pb = restrict_rows(fr.blend_setup(sd, params, rcfg), y0b, hsb,
                                 SPONZA_H)
        prep_pb = fr.blend_pairs(sd, setup_pb, rcfg, hsb, y0b)
        bpb = prep_pb.bins
        pb_bounds = torch.stack([torch.full_like(band_depth, -1.0),
                                 band_depth], 1).contiguous()
        # the grid the frame gives this launch: sparse when the renderer's
        # tile budget is below the band's tile count
        pb_map = (cr.sparse_tile_map(bpb.counts, rcfg.blend_tile_budget)
                  if rcfg.blend_tile_budget < ob_tiles else None)
        pb_sel = ob_tiles if pb_map is None else int(pb_map.shape[0])
        err, st_pb, pb_plain_ms = k1_plain_check(
            cr, prep_pb, ntx_b, SPONZA_W, SPONZA_H,
            f"per-pixel dual peel band y0={y0b}, {pb_sel} of {ob_tiles} "
            f"tiles", pb_bounds, pb_map, True, y0=y0b)
        max_err["band_peel2"] = err
        pb_args = (prep_pb.pair_data, bpb.starts, bpb.counts, ntx_b,
                   SPONZA_W, SPONZA_H, y0b, 8, pb_bounds, pb_map, True)
        (pb_solo,) = solo_counts(bpb.counts)
        times["raster_tile_peel2_band"] = time_shape(
            f"per-pixel dual peel band y0={y0b}",
            lambda: cr.raster_tiles(*pb_args),
            lambda: cr.raster_tiles(*pb_args[:2], pb_solo, *pb_args[3:]))
        pb_pairs = int(bpb.counts.sum() if pb_map is None
                       else bpb.counts[pb_map.long()].sum())
        pb_bound = k1_bound(pb_pairs, pb_sel, prep_pb.pair_data.shape[1], 8,
                            st_pb["wins"], st_pb["demotes"], peel=True,
                            dual=True, sparse=pb_map is not None)
        band_rows = {
            "raster_tile_band": {"pairs": ob_pairs, "plain_ms": ob_plain_ms,
                                 "bound": ob_bound},
            "raster_tile_peel2_band": {"pairs": pb_pairs,
                                       "plain_ms": pb_plain_ms,
                                       "bound": pb_bound}}
        log(f"phase k1-band: opaque {ob_pairs} pairs over {ob_tiles} tiles, "
            f"{times['raster_tile_band']['ms']:.4f} ms, bound "
            f"{ob_bound[0]:.4f} ms ({ob_bound[1]}); dual peel {pb_pairs} "
            f"pairs over {pb_sel} slots, "
            f"{times['raster_tile_peel2_band']['ms']:.4f} ms, bound "
            f"{pb_bound[0]:.4f} ms ({pb_bound[1]})")
        del prep_ob, prep_pb, pb_bounds, band_depth
        # the single-card reference of the sharded phase
        pp_img, pp_st = fr.render_frame(
            sd, u, renderer._shadow_maps, rcfg, n_maps, "cuda", True,
            renderer._slots_used, shadow_lights=renderer._shadow_lights,
            has_mask=renderer._has_mask)
        pp_over = {k: int(v) for k, v in pp_st.items() if "overflow" in k}
        if any(pp_over.values()) or renderer.shadow_overflow:
            raise AssertionError(f"reference frame counters {pp_over}")
        pp_ref = {"config": rcfg, "frame": pp_img.cpu(),
                  "maps": tuple(t.cpu() for t in renderer._shadow_maps),
                  "shadow_budget": renderer._shadow_budget_val,
                  "frame_ms": ref_frame_ms(lambda: fr.render_frame(
                      sd, u, renderer._shadow_maps, rcfg, n_maps, "cuda",
                      True, renderer._slots_used,
                      shadow_lights=renderer._shadow_lights,
                      has_mask=renderer._has_mask))}
        log(f"phase k1-band: single-card reference frame, budgets: pair "
            f"{rcfg.raster.pair_budget} (dense_k {rcfg.raster.dense_k}), "
            f"blend pair {rcfg.blend_pair_budget}, blend tile "
            f"{rcfg.blend_tile_budget}, shade tiles "
            f"{rcfg.blend_layer_tile_budgets}, penumbra "
            f"{rcfg.penumbra_tile_budget}, shadow pair "
            f"{renderer._shadow_budget_val}; counters {pp_over}")
        del pp_img
    except Exception as e:  # noqa: BLE001
        fail(phase, e)

    # the texture-space path: the JAX package's headline configuration
    del renderer
    torch.cuda.empty_cache()
    phase = "tss-renderer"
    try:
        tss_cfg = RenderConfig(width=SPONZA_W, height=SPONZA_H,
                               debug_views=False, texture_space=True,
                               tss_preshaded_blend=True,
                               dither_trilinear=True, sky_halfres=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        tss_r = fr.FrameRenderer(scene, tss_cfg)
        torch.cuda.synchronize()
        tss_init_s = time.time() - t0
        tcfg = tss_r.config
        tsd = tss_r.scene_dev
        c_ah, c_aw = tsd["chart_tri"].shape
        n_texels = int((tsd["chart_tri"] >= 0).sum())
        tss_tris = int(tsd["n_tris"])
        # the upload bake again, timed alone on the card
        bake_ms = cuda_ms(lambda: lightchart.setup_scene_tss(
            tsd, tcfg, tss_r._slots_used, tss_r._baked_exposure,
            tss_r._alpha_is_factor), 2)
        log(f"phase tss-renderer: set up in {tss_init_s:.1f} s (chart "
            f"subdivision, layout, bake): {tss_tris} triangles after "
            f"subdivision, atlas {c_ah}x{c_aw} with {n_texels} live texels,"
            f" upload bake {bake_ms:.2f} ms on the card, alpha is factor "
            f"{tss_r._alpha_is_factor}; pair budget "
            f"{tcfg.raster.pair_budget}, blend pair budget "
            f"{tcfg.blend_pair_budget}, blend tile budget "
            f"{tcfg.blend_tile_budget}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        tu = torch.from_numpy(tss_r.uniform_for_camera()).to(dev)
        tparams = fr.unpack_params(tu, tss_r.n_shadows)
    except Exception as e:  # noqa: BLE001
        fail(phase, e)

    # phase: K1 at 4 attributes, the TSS opaque pass at 1080p
    phase = "k1-tss"
    try:
        setup_a = fr.opaque_setup(tsd, tparams, tcfg)
        prep_a = fr.opaque_pairs(tsd, setup_a, tcfg)
        ba = prep_a.bins
        if int(ba.n_overflow) or int(ba.n_tail):
            raise AssertionError("TSS opaque pair overflow")
        err, st_a, ta_plain_ms = k1_plain_check(
            cr, prep_a, ntx, SPONZA_W, SPONZA_H, "sponza 1080p tss opaque")
        max_err["tss"] = max(max_err["tss"], err)
        pairs_a = int(ba.counts.sum())
        ta_args = (prep_a.pair_data, ba.starts, ba.counts, ntx, SPONZA_W,
                   SPONZA_H, 0, 4)
        (ta_solo,) = solo_counts(ba.counts)
        ta_solo_args = ta_args[:2] + (ta_solo,) + ta_args[3:]
        times["raster_tile_tss"] = time_shape(
            "TSS opaque", lambda: cr.raster_tiles(*ta_args),
            lambda: cr.raster_tiles(*ta_solo_args))
        ta_ms = times["raster_tile_tss"]["ms"]
        ta_bound, ta_by, ta_ops, ta_bytes = k1_bound(
            pairs_a, n_tiles, prep_a.pair_data.shape[1], 4, st_a["wins"])
        log(f"phase k1-tss: {pairs_a} pairs over {n_tiles} tiles (max "
            f"{int(ba.counts.max())}/tile), {st_a['wins']} depth wins; K1 "
            f"{ta_ms:.4f} ms, plain {ta_plain_ms:.2f} ms, bound "
            f"{ta_bound:.4f} ms ({ta_by}: {ta_ops:.3e} ops, {ta_bytes:.3e} "
            f"B)")
    except Exception as e:  # noqa: BLE001
        fail(phase, e)

    # phase: the headline K2 launch at 1080p — K2 vs plain and vs the
    # separate K1 launches, timings; then the K1 dual peel it replaces
    phase = "k2-sponza"
    try:
        setup_b = fr.blend_setup(tsd, tparams, tcfg)
        prep_b = fr.blend_pairs(tsd, setup_b, tcfg)
        bb = prep_b.bins
        if int(bb.n_overflow) or int(bb.n_tail):
            raise AssertionError("TSS blend pair overflow")
        pairs_b = int(bb.counts.sum())
        k2 = {}
        for nab in (2, 4):
            err, st_k2, k2_plain_ms = k2_check(
                cr, prep_a, prep_b, ntx, SPONZA_W, SPONZA_H, nab,
                f"sponza 1080p headline, n_attrs_b={nab}")
            max_err[f"k2_{nab}"] = max(max_err[f"k2_{nab}"], err)
            k2_args = (prep_a.pair_data, ba.starts, ba.counts,
                       prep_b.pair_data, bb.starts, bb.counts, ntx,
                       SPONZA_W, SPONZA_H, 0, nab)
            (sa, sb) = solo_counts(ba.counts, bb.counts)
            k2_solo = (k2_args[:2] + (sa,) + k2_args[3:5] + (sb,)
                       + k2_args[6:])
            name = "merged_tile" if nab == 2 else "merged_tile_b4"
            times[name] = time_shape(
                f"K2 n_attrs_b={nab}", lambda: cr.merged_tiles(*k2_args),
                lambda: cr.merged_tiles(*k2_solo))
            k2_ms = times[name]["ms"]
            bound = k2_bound(pairs_a, pairs_b, n_tiles, nab, st_k2["wins"],
                             st_k2["wins_b"], st_k2["demotes"])
            k2[nab] = {"ms": k2_ms, "plain_ms": k2_plain_ms,
                       "bound_ms": bound[0], "bound_by": bound[1],
                       "ops": bound[2], "bytes": bound[3],
                       "wins_a": st_k2["wins"], "wins_b": st_k2["wins_b"],
                       "demotes": st_k2["demotes"]}
            log(f"phase k2-sponza: n_attrs_b={nab}: {pairs_a} + {pairs_b} "
                f"pairs over {n_tiles} tiles (blend max "
                f"{int(bb.counts.max())}/tile, {int((bb.counts > 0).sum())} "
                f"covered tiles); K2 {k2_ms:.4f} ms, plain "
                f"{k2_plain_ms:.2f} ms, bound {bound[0]:.4f} ms ({bound[1]}"
                f": {bound[2]:.3e} ops, {bound[3]:.3e} B)")
        # the K1 dual peel at 4 attributes that K2 folds in (bounds: -1 and
        # the opaque depth), against its plain version, timed
        opq = cr.raster_tiles(*ta_args)
        tb_bounds = torch.stack([torch.full_like(opq[:, 0], -1.0),
                                 opq[:, 0]], 1).contiguous()
        err, st_tp, tp_plain_ms = k1_plain_check(
            cr, prep_b, ntx, SPONZA_W, SPONZA_H, "sponza 1080p tss dual peel",
            tb_bounds, None, True)
        max_err["tss_peel2"] = max(max_err["tss_peel2"], err)
        tp_args = (prep_b.pair_data, bb.starts, bb.counts, ntx, SPONZA_W,
                   SPONZA_H, 0, 4, tb_bounds, None, True)
        (tp_solo,) = solo_counts(bb.counts)
        tp_solo_args = tp_args[:2] + (tp_solo,) + tp_args[3:]
        times["raster_tile_tss_peel2"] = time_shape(
            "TSS dual peel", lambda: cr.raster_tiles(*tp_args),
            lambda: cr.raster_tiles(*tp_solo_args))
        tp_ms = times["raster_tile_tss_peel2"]["ms"]
        tp_bound, tp_by, tp_ops, tp_bytes = k1_bound(
            pairs_b, n_tiles, 32, 4, st_tp["wins"], st_tp["demotes"],
            peel=True, dual=True)
        log(f"phase k2-sponza: the K1 launches K2 replaces: opaque "
            f"{ta_ms:.4f} ms + dual peel {tp_ms:.4f} ms (plain "
            f"{tp_plain_ms:.2f} ms, bound {tp_bound:.4f} ms {tp_by})")
        # the per-frame specular chart pass, timed alone on the card
        spec_ms = cuda_ms(lambda: lightchart.chart_light_spec(
            tsd, tsd["chart_pos"], tsd["chart_normal"], tsd["chart_mat"],
            tsd["chart_vis"], {"view_pos": tparams["view_pos"],
                               "exposure": tparams["exposure"]}), 10)
        del prep_a, prep_b, opq, tb_bounds
    except Exception as e:  # noqa: BLE001
        fail(phase, e)

    # phase: K2 on the lower band of the 1080p headline frame, against its
    # plain version and the separate K1 launches: from the mid-tile row
    # 540, then as the second of two ranks launches it (rows 536-1079:
    # sharded.band_extent), timed
    phase = "k2-band"
    try:
        from renderengine_tpu_torch.parallel import sharded

        y0m = SPONZA_H // 2
        k2_check(cr, fr.opaque_pairs(
            tsd, restrict_rows(setup_a, y0m, y0m, SPONZA_H), tcfg, y0m, y0m),
            fr.blend_pairs(tsd, restrict_rows(fr.blend_setup(
                tsd, tparams, tcfg), y0m, y0m, SPONZA_H), tcfg, y0m, y0m),
            ntx, SPONZA_W, SPONZA_H, 2,
            f"headline y0={y0m} (mid-tile), n_attrs_b=2", y0=y0m)
        y0b, ye_b = sharded.band_extent(tcfg, y0m, SPONZA_H - y0m)
        hsb = ye_b - y0b
        sa_b = restrict_rows(setup_a, y0b, hsb, SPONZA_H)
        pa_b = fr.opaque_pairs(tsd, sa_b, tcfg, hsb, y0b)
        sb_b = restrict_rows(fr.blend_setup(tsd, tparams, tcfg), y0b, hsb,
                             SPONZA_H)
        pb_b = fr.blend_pairs(tsd, sb_b, tcfg, hsb, y0b)
        err, st_kb, kb_plain_ms = k2_check(
            cr, pa_b, pb_b, ntx, SPONZA_W, SPONZA_H, 2,
            f"headline band y0={y0b}, n_attrs_b=2", y0=y0b)
        max_err["band_k2"] = err
        kb_args = (pa_b.pair_data, pa_b.bins.starts, pa_b.bins.counts,
                   pb_b.pair_data, pb_b.bins.starts, pb_b.bins.counts, ntx,
                   SPONZA_W, SPONZA_H, y0b, 2)
        (kb_sa, kb_sb) = solo_counts(pa_b.bins.counts, pb_b.bins.counts)
        kb_solo = kb_args[:2] + (kb_sa,) + kb_args[3:5] + (kb_sb,) \
            + kb_args[6:]
        times["merged_tile_band"] = time_shape(
            f"K2 band y0={y0b}", lambda: cr.merged_tiles(*kb_args),
            lambda: cr.merged_tiles(*kb_solo))
        kb_pa = int(pa_b.bins.counts.sum())
        kb_pb = int(pb_b.bins.counts.sum())
        kb_tiles = int(pa_b.bins.counts.shape[0])
        kb_bound = k2_bound(kb_pa, kb_pb, kb_tiles, 2, st_kb["wins"],
                            st_kb["wins_b"], st_kb["demotes"])
        band_rows["merged_tile_band"] = {"pairs": kb_pa + kb_pb,
                                         "plain_ms": kb_plain_ms,
                                         "bound": kb_bound}
        log(f"phase k2-band: {kb_pa} + {kb_pb} pairs over {kb_tiles} tiles, "
            f"K2 {times['merged_tile_band']['ms']:.4f} ms, plain "
            f"{kb_plain_ms:.2f} ms, bound {kb_bound[0]:.4f} ms "
            f"({kb_bound[1]})")
        del pa_b, pb_b
    except Exception as e:  # noqa: BLE001
        fail(phase, e)

    # phase: the texture-space paths, each counted on its own: the headline
    # frame x TSS_FRAMES; then one frame each of factored shading (4
    # translucent layers: K2 + a K1 dual peel), fully pre-shaded shading and
    # shading without translucency (K1 at 4 attributes, no K2). Every one
    # is rendered again through the plain versions, and the headline frame
    # through separate K1 launches (uncounted): all identical
    phase = "tss-path"
    try:
        k2_v2, k2_v4 = ("merged", 2), ("merged", 4)
        k1_tss_v, k1_tss_peel_v = (4, False, False), (4, True, True)
        tss_variants = (k2_v2, k2_v4, k1_tss_v, k1_tss_peel_v, shadow_v)

        def path_counts():
            return {v: cr.variant_counts[v] for v in tss_variants}

        def plain_frame(r):
            """The renderer's last frame dispatched op by op through the
            plain versions."""
            with mock.patch.object(cr, "raster_tiles",
                                   cr._raster_tiles_plain), \
                    mock.patch.object(cr, "merged_tiles",
                                      cr._merged_tiles_plain), \
                    mock.patch.object(lightchart, "tss_peel_composite",
                                      lightchart.tss_peel_composite_plain):
                return r.render_eager()[0]

        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tss_ms, tss_per_frame, tss_stats, tss_helpers = [], [], [], []
        tss_caps = []
        for _ in range(TSS_FRAMES):
            before = dict(cr.variant_counts)
            h_before = dict(cr.helper_counts)
            p_before = dict(tss_r.program_counts)
            t0 = time.perf_counter()
            timg, tst = tss_r.render()
            torch.cuda.synchronize()
            tss_ms.append((time.perf_counter() - t0) * 1e3)
            tss_caps.append(counts_delta(p_before, tss_r.program_counts))
            tss_per_frame.append({str(v): cr.variant_counts[v]
                                  - before.get(v, 0) for v in tss_variants
                                  if cr.variant_counts[v] - before.get(v, 0)})
            tss_helpers.append({k: cr.helper_counts[k] - h_before[k]
                                for k in cr.helper_counts})
            tss_stats.append({k: v.tolist() for k, v in tst.items()})
        path_launches = {"headline": path_counts()}
        tss_mem = {"workspace_bytes": cr.workspace_bytes(),
                   "peak_bytes": torch.cuda.max_memory_allocated()}
        vis_ms = cuda_ms(lambda: (lightchart.bake_visibility(
            tsd, {"pos": tsd["chart_pos"], "normal": tsd["chart_normal"],
                  "mat_id": tsd["chart_mat"][15]}, tss_r._shadow_maps,
            tparams["shadow_viewproj"], tss_r._shadow_lights),
            lightchart.static_tables(tsd, tcfg, tss_r._baked_exposure)), 2)
        log(f"phase tss-path: frame ms {tss_ms} (one block per tile, warm: "
            f"{BEFORE_SPLIT_FRAME_MS['tss']}), launches {tss_per_frame}, workspace "
            f"zeroings {tss_helpers}; split-walk workspace "
            f"{tss_mem['workspace_bytes']} B, peak device memory of the "
            f"frames {tss_mem['peak_bytes']} B; "
            f"specular chart pass {spec_ms:.3f} ms, visibility bake + static"
            f" tables {vis_ms:.2f} ms on the card; counters {tss_stats}; "
            f"shadow overflow {tss_r.shadow_overflow}; captures and replays "
            f"{tss_caps}; programs {tss_r.program_stats()}")
        for i, pf in enumerate(tss_per_frame):
            want = {str(k): n for k, n in expected_launches(
                {k2_v2: 1}, tss_caps[i], tss_r.n_shadows, shadow_v).items()}
            if tss_caps[i]["frame_replays"] != 1:
                raise AssertionError(f"TSS frame {i}: {tss_caps[i]}")
            if tss_helpers[i]["workspace_zero"] > sum(pf.values()):
                raise AssertionError(f"TSS frame {i}: zeroings "
                                     f"{tss_helpers[i]}")
            if pf != want:
                raise AssertionError(f"TSS frame {i}: launches {pf}, "
                                     f"expected {want}")
        for i, st in enumerate(tss_stats[1:], 1):
            over = {k: v for k, v in st.items() if "overflow" in k}
            if any(over.values()) or tss_r.shadow_overflow:
                raise AssertionError(f"TSS frame {i}: overflow {over}")
        timg_np = timg.cpu().numpy()
        if timg_np.shape != (SPONZA_H, SPONZA_W, 4) or \
                timg_np.dtype != np.uint8:
            raise AssertionError(f"bad TSS image {timg_np.shape}")
        lit = float((timg_np[..., :3].max(-1) > 0).mean())
        # against the per-pixel default frame of the same view: lighting
        # lives at chart resolution, the sky is upsampled and mips dither
        d = np.abs(timg_np[..., :3].astype(np.int32)
                   - img_np[..., :3].astype(np.int32)).max(-1)
        vs_pp = {"mean": float(d.mean()), "within_16": float((d <= 16).mean()),
                 "within_32": float((d <= 32).mean())}
        log(f"phase tss-path: {lit:.4f} of the pixels lit; against the "
            f"per-pixel default frame: {vs_pp}")
        if lit < 0.9 or vs_pp["mean"] > 20.0 or vs_pp["within_32"] < 0.8:
            raise AssertionError("the TSS frame is far from the per-pixel "
                                 "frame")
        # the same frame with K2 replaced by K1's opaque + dual launches,
        # dispatched op by op: identical, byte for byte. Unmerged peels
        # are shaded through shade_sparse: at one tile short of the dense
        # path every tile of every tile row is shaded per pixel, as the
        # peel kernel shades the merged ones
        fr._FORCE_UNMERGED = True
        try:
            every = tss_r._shade_tile_total() - 1
            unm, _ = fr.render_frame(
                tsd, tss_r._u, tss_r._shadow_maps, tss_r.config.replace(
                    blend_layer_tile_budgets=(every, every)),
                tss_r.n_shadows, "cuda", True, tss_r._slots_used,
                shadow_lights=tss_r._shadow_lights,
                has_mask=tss_r._has_mask,
                alpha_is_factor=tss_r._alpha_is_factor)
        finally:
            fr._FORCE_UNMERGED = False
        same = torch.equal(unm, timg)
        log(f"phase tss-path: through separate K1 launches identical: {same}")
        if not same:
            raise AssertionError("the merged and unmerged frames differ")
        same = torch.equal(plain_frame(tss_r), timg)
        log(f"phase tss-path: through the plain versions identical: {same}")
        if not same:
            raise AssertionError("the kernel frame differs from the plain one")
        # the single-card reference of the sharded phase: the headline
        # frame with the renderer's budgets after its frames
        t_img, t_st = fr.render_frame(
            tsd, tu, tss_r._shadow_maps, tss_r.config, tss_r.n_shadows,
            "cuda", True, tss_r._slots_used,
            shadow_lights=tss_r._shadow_lights, has_mask=tss_r._has_mask,
            alpha_is_factor=tss_r._alpha_is_factor)
        t_over = {k: int(v) for k, v in t_st.items() if "overflow" in k}
        log(f"phase tss-path: the sharded phase's reference frame: "
            f"counters {t_over}, equal to the last headline frame "
            f"{torch.equal(t_img, timg)}")
        if any(t_over.values()):
            raise AssertionError(f"TSS reference frame: counters {t_over}")
        tss_ref = {"config": tss_r.config, "frame": t_img.cpu(),
                   "maps": tuple(t.cpu() for t in tss_r._shadow_maps),
                   "shadow_budget": tss_r._shadow_budget_val,
                   "frame_ms": ref_frame_ms(lambda: fr.render_frame(
                       tsd, tu, tss_r._shadow_maps, tss_r.config,
                       tss_r.n_shadows, "cuda", True, tss_r._slots_used,
                       shadow_lights=tss_r._shadow_lights,
                       has_mask=tss_r._has_mask,
                       alpha_is_factor=tss_r._alpha_is_factor))}
        del t_img
        del tss_r, tsd, unm
        torch.cuda.empty_cache()
        modes = {}
        for mode, extra, want in (
                ("factored", dict(tss_preshaded_blend=False,
                                  translucency_layers=4),
                 {k2_v4: 1, k1_tss_peel_v: 1}),
                ("preshaded", dict(tss_preshaded_blend=False,
                                   tss_preshaded=True), {k2_v2: 1}),
                ("no_translucency", dict(translucency=False),
                 {k1_tss_v: 1})):
            r = fr.FrameRenderer(scene, tss_cfg.replace(**extra))
            reset_counts()
            t0 = time.perf_counter()
            mimg, mst = r.render()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            path_launches[mode] = path_counts()
            path_helpers = dict(cr.helper_counts)
            got = {str(v): n for v, n in path_launches[mode].items() if n}
            want = {str(v): n for v, n in want.items()}
            want[str(shadow_v)] = r.n_shadows
            # a second frame through the kernels (the shadow maps are now
            # cached), then the same through the plain versions
            kimg, _ = r.render()
            same = torch.equal(plain_frame(r), kimg)
            m_np = mimg.cpu().numpy()
            dm = np.abs(m_np[..., :3].astype(np.int32)
                        - timg_np[..., :3].astype(np.int32)).max(-1)
            modes[mode] = {"frame_ms": ms, "launches": got,
                           "workspace_zeroings": path_helpers,
                           "vs_headline_mean": float(dm.mean()),
                           "lit": float((m_np[..., :3].max(-1) > 0).mean()),
                           "plain_identical": same,
                           "counters": {k: v.tolist()
                                        for k, v in mst.items()}}
            log(f"phase tss-path: {mode}: {modes[mode]}")
            if got != want or modes[mode]["lit"] < 0.9:
                raise AssertionError(f"{mode}: launches {got}, expected "
                                     f"{want}")
            if not same:
                raise AssertionError(f"{mode}: the kernel frame differs from"
                                     f" the plain one")
            del r, mimg, kimg
            torch.cuda.empty_cache()
        log(f"phase tss-path: launches by path {path_launches}")
    except Exception as e:  # noqa: BLE001
        fail(phase, e)

    # phase: the benchmark's orbit (bench_torch.py) on the TSS headline and
    # the per-pixel default at 1080p: settling, a round of frames in
    # flight, replayed against eager at one pose, counters 0
    phase = "orbit"
    try:
        pp_cfg = RenderConfig(width=SPONZA_W, height=SPONZA_H)
        orbit_res, ws_keep = orbit_phase(fr, cr, scene, tss_cfg, pp_cfg,
                                         dev, reset_counts)
    except Exception as e:  # noqa: BLE001
        fail(phase, e)

    # phase: SSAA x2 at 1080p (3840x2160 inside): both configs captured,
    # replayed and held to eager; K2 and both K1 launches at 3840x2160
    # bit-exact against their plain versions, timed
    phase = "ssaa2"
    try:
        ssaa2_rows = {}
        ssaa2_res = ssaa2_phase(fr, cr, scene, tss_cfg, pp_cfg, dev,
                                reset_counts, times, ssaa2_rows)
    except Exception as e:  # noqa: BLE001
        fail(phase, e)

    # the workspace check: a 1080p frame captured before phase ssaa2 grew
    # the split walk's workspace replays as it did
    phase = "workspace"
    try:
        ws_res = workspace_phase(cr, ws_keep, scene, dev)
        del ws_keep
        torch.cuda.empty_cache()
    except Exception as e:  # noqa: BLE001
        fail(phase, e)

    # phase: the tiered anisotropic sampler's kernel at the per-pixel
    # frame's opaque and peel shapes, bit-exact against its plain version
    # and timed
    phase = "aniso"
    try:
        aniso_rows, aniso_res = aniso_phase(fr, cr, scene, pp_cfg, dev,
                                            reset_counts)
    except Exception as e:  # noqa: BLE001
        fail(phase, e)

    # phase: the texture-space peel pass's kernel at the headline's 1080p
    # and 3840x2160 (ssaa=2) calls, bit-exact against its plain version
    # and timed
    phase = "tss-peel"
    try:
        peel_rows, peel_res = tss_peel_phase(fr, cr, scene, tss_cfg, dev,
                                             reset_counts)
    except Exception as e:  # noqa: BLE001
        fail(phase, e)

    # phase: the factored texture-space screen pass's kernel at the
    # headline's 1080p and 3840x2160 (ssaa=2) calls, bit-exact against its
    # plain version and timed
    phase = "tss-shade"
    try:
        shade_rows, shade_res = tss_shade_phase(fr, cr, scene, tss_cfg, dev,
                                                reset_counts)
    except Exception as e:  # noqa: BLE001
        fail(phase, e)

    # phase: the point-light cube's six 4096^2 faces through K1 on the
    # cube configuration, bit-exact against the plain version and timed
    phase = "k1-cube"
    try:
        cube_rows, cube_res = cube_face_phase(fr, cr, tss_cfg)
    except Exception as e:  # noqa: BLE001
        fail(phase, e)

    # phase: the compiled frame. For the per-pixel default, the TSS
    # headline and the app's per-pixel config (2048^2 maps), each with the
    # poll on: the renderer captures its frame and shadow programs at init
    # (FrameRenderer.program_stats: capture and instantiate ms, the graph
    # pools' bytes); after 4 settling frames, 3 warm render() calls run
    # under set_sync_debug_mode("error") and replay the frame program (no
    # capture, no call of render_frame, the launches of 3 frames); for 3
    # camera poses the replayed frame equals render_frame dispatched op by
    # op at the same budgets, byte for byte, every counter 0; a pair
    # overflow fed to the poll re-tunes and recaptures, and the frame
    # still equals its eager frame, as does the frame after
    # mark_shadows_dirty(); then the warm frame ms replayed against eager
    # (median of 10 each, alternating), torch.profiler over replays and
    # (one frame) and over one eager frame (busy share, kernels a frame)
    # and RenderLoop against render() + .cpu()
    phase = "graph-path"
    try:
        import copy
        import inspect

        from renderengine_tpu_torch.scene.camera import ViewProperties
        from renderengine_tpu_torch.shading import fitting
        from renderengine_tpu_torch.tools import profile_frame
        from renderengine_tpu_torch.tools.sync_sites import sync_sites
        t_graph = time.time()
        graph_res = {}
        cam0 = copy.deepcopy(scene.camera)
        eye0 = np.asarray(cam0.eye, np.float32)
        target0 = np.asarray(cam0.look_at, np.float32)
        up0 = np.asarray(getattr(cam0, "up", (0.0, 1.0, 0.0)), np.float32)

        def pose(a):
            d = eye0 - target0
            c, s_ = np.cos(a), np.sin(a)
            scene.camera.set_camera_view(
                target0 + np.array([c * d[0] - s_ * d[2], d[1],
                                    s_ * d[0] + c * d[2]], np.float32),
                target0, up0)

        def over(st):
            return {k: int(v) for k, v in st.items() if "overflow" in k}

        def prof_summary(p):
            return {k: p[k] for k in ("wall_ms_per_frame",
                                      "device_busy_ms_per_frame",
                                      "device_busy_share",
                                      "kernel_launches_per_frame")} | {
                "top_kernels": p["top_kernels"][:5]}

        def eager_bakes_frame(r, visibility):
            # the TSS bakes and the frame dispatched op by op over the
            # renderer's state (uniform, shadow pack)
            fr.bake_tss(r.tss_bakes(visibility))
            return r.render_eager()[0]

        def alternate_ms(replayed, eager, n=5):
            # host ms of n frames replayed and n dispatched op by op, in
            # turns, frame i of each alike; each call ends in a synchronize
            acc = {"replayed": [], "eager": []}
            for i in range(n):
                for mode, frame in (("replayed", replayed),
                                    ("eager", eager)):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    frame(i)
                    torch.cuda.synchronize()
                    acc[mode].append((time.perf_counter() - t0) * 1e3)
            return {"replayed_median": statistics.median(acc["replayed"]),
                    "eager_median": statistics.median(acc["eager"]), **acc}

        def tss_bake_checks(r):
            # the bake programs (the JAX _vis_fn and _ld_fn): an exposure
            # change replays the tables under sync debug mode "error", a
            # shadow-dirty frame makes one synchronizing call (the shadow
            # pass's overflow read); both equal the eager bakes' frame;
            # then each kind of frame replayed against eager, 5 each
            out = {}
            react, r._react_overflow = r._react_overflow, False
            e0 = float(scene.camera.exposure)

            def at(scale):
                vp = ViewProperties.from_camera(scene.camera)
                vp.exposure = e0 * scale
                return vp

            torch.cuda.synchronize()
            p0 = dict(r.program_counts)
            torch.cuda.set_sync_debug_mode("error")
            try:
                img, st = r.render(at(1.5))
            finally:
                torch.cuda.set_sync_debug_mode(0)
            out["exposure"] = {
                "sync_calls": 0, "replays": {
                    k: v for k, v in counts_delta(
                        p0, r.program_counts).items() if v},
                "equal": torch.equal(img, eager_bakes_frame(r, False)),
                "counters": over(st)}
            r.render()              # back at the camera's exposure
            p0 = dict(r.program_counts)
            r.mark_shadows_dirty()
            got = []
            sites = sync_sites(lambda: got.append(r.render()))
            img, st = got[0]
            lines, first = inspect.getsourcelines(
                fr.FrameRenderer._render_shadows)
            line = first + next(i for i, t in enumerate(lines)
                                if "int(sov)" in t)
            out["dirty"] = {
                "sync": sites, "overflow_read_line": line,
                "replays": {k: v for k, v in counts_delta(
                    p0, r.program_counts).items() if v},
                "equal": torch.equal(img, eager_bakes_frame(r, True)),
                "counters": over(st), "shadow_overflow": r.shadow_overflow}
            log(f"phase graph-path [tss bakes]: exposure {out['exposure']}; "
                f"dirty {out['dirty']}")
            want = {"exposure": {"tables_replays": 1, "frame_replays": 1},
                    "dirty": {"shadow_replays": 1, "vis_replays": 1,
                              "tables_replays": 1, "frame_replays": 1}}
            for kind in want:
                c = out[kind]
                if (not c["equal"] or any(c["counters"].values())
                        or c["replays"] != want[kind]):
                    raise AssertionError(f"TSS {kind} frame: {c}")
            site = next(iter(sites["sites"]), "")
            if sites["calls"] != 1 or not site.startswith(
                    f"/graph/frame.py:{line}") or r.shadow_overflow:
                raise AssertionError(f"TSS dirty frame syncs: {sites}")
            # each replayed exposure differs from the one before it; the
            # eager frame i bakes the tables at the replayed frame i's
            def scale(i):
                return 1.5 if i % 2 == 0 else 1.0

            out["exposure_frame_ms"] = alternate_ms(
                lambda i: r.render(at(scale(i))),
                lambda i: profile_frame.eager_frame(r, at(scale(i))))

            def dirty(i):
                r.mark_shadows_dirty()
                r.render()

            out["dirty_frame_ms"] = alternate_ms(
                dirty, lambda i: profile_frame.eager_frame(r, dirty=True))
            # the dirty frame's host-side shadow refit (the light fit that
            # precedes the shadow pass; the card idles through it)
            refit = []
            for _ in range(5):
                t0 = time.perf_counter()
                fitting.shadow_transforms_for_scene(scene)
                refit.append((time.perf_counter() - t0) * 1e3)
            out["shadow_refit_host_ms"] = {
                "median": statistics.median(refit), "all": refit}
            ps = r.program_stats()
            out["programs"] = {k: ps[k] for k in ("vis", "tables")}
            r.render()
            r._react_overflow = react
            log(f"phase graph-path [tss bakes]: exposure-change frame ms "
                f"replayed {out['exposure_frame_ms']['replayed_median']:.2f}"
                f" vs eager {out['exposure_frame_ms']['eager_median']:.2f}; "
                f"shadow-dirty frame ms replayed "
                f"{out['dirty_frame_ms']['replayed_median']:.2f} vs eager "
                f"{out['dirty_frame_ms']['eager_median']:.2f} (median of 5 "
                f"each, alternating), of which the host's shadow refit "
                f"{out['shadow_refit_host_ms']['median']:.2f}; bake programs "
                f"{out['programs']}; {card}")
            return out

        app_cfg_pp = RenderConfig(width=SPONZA_W, height=SPONZA_H,
                                  shadow_extent=2048, chart_density=0.5)
        for tag, gcfg in (("per_pixel",
                           RenderConfig(width=SPONZA_W, height=SPONZA_H)),
                          ("tss_headline", tss_cfg),
                          ("app_per_pixel", app_cfg_pp)):
            res = {}
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            alloc0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            r = fr.FrameRenderer(scene, gcfg)
            torch.cuda.synchronize()
            res["init_s"] = time.time() - t0
            res["init_peak_bytes"] = torch.cuda.max_memory_allocated() - alloc0
            res["init_programs"] = r.program_stats()
            for _ in range(4):
                r.render()
                torch.cuda.synchronize()
            # three warm frames under the sync guard: replays only
            eager_calls = []
            orig_rf = fr.render_frame

            def counting_rf(*a, **k):
                eager_calls.append(1)
                return orig_rf(*a, **k)

            reset_counts()
            p0 = dict(r.program_counts)
            with mock.patch.object(fr, "render_frame", counting_rf):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    for _ in range(3):
                        img, st = r.render()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            warm = counts_delta(p0, r.program_counts)
            got = {str(k): n for k, n in cr.variant_counts.items()}
            want = {str(k): 3 * n
                    for k, n in r._programs.progs["frame"].launches[1].items()}
            res["warm"] = {"sync_calls": 0, "renders": warm,
                           "render_frame_calls": len(eager_calls),
                           "launches": got, "counters": over(st)}
            log(f"phase graph-path [{tag}]: init {res['init_s']:.1f} s, "
                f"programs {res['init_programs']}; 3 warm render() under "
                f"sync debug mode 'error': {res['warm']}")
            if (warm["frame_replays"] != 3 or warm["frame_captures"]
                    or warm["shadow_replays"]
                    or eager_calls or got != want or any(over(st).values())):
                raise AssertionError(f"{tag}: warm frames {res['warm']}, "
                                     f"launches expected {want}")
            # three camera poses: the replay against the eager frame
            poses = []
            for a in (0.0, 0.06, 0.12):
                pose(a)
                img, st = r.render()
                e_img, e_st = r.render_eager()
                poses.append({"angle": a, "equal": torch.equal(img, e_img),
                              "counters": over(st),
                              "eager_counters": over(e_st),
                              "shadow_overflow": r.shadow_overflow})
            scene.camera = copy.deepcopy(cam0)
            res["poses"] = poses
            # a forced re-tune through the poll: a pair overflow grows the
            # pair budget, the frame program is captured again
            torch.cuda.synchronize()
            r._pending_overflow.clear()
            z = torch.zeros((), dtype=torch.int64, device=dev)
            r._queue_stats({"pair_overflow": z + 4096,
                            "pair_tail_overflow": z,
                            "blend_pair_overflow": z})
            torch.cuda.synchronize()
            caps0 = r.program_counts["frame_captures"]
            b0 = r.config.raster.pair_budget
            img, st = r.render()
            e_img, e_st = r.render_eager()
            res["retune"] = {
                "pair_budget": [b0, r.config.raster.pair_budget],
                "captures": r.program_counts["frame_captures"] - caps0,
                "equal": torch.equal(img, e_img), "counters": over(st),
                "recapture": r.program_stats()["frame"]}
            # mark_shadows_dirty(): the shadow program replays into the pack
            ptrs = [t.data_ptr() for t in r._shadow_maps]
            s0 = r.program_counts["shadow_replays"]
            r.mark_shadows_dirty()
            img, st = r.render()
            e_img, e_st = r.render_eager()
            res["dirty_shadows"] = {
                "equal": torch.equal(img, e_img), "counters": over(st),
                "shadow_replays": r.program_counts["shadow_replays"] - s0,
                "shadow_overflow": r.shadow_overflow,
                "pack_kept": ptrs == [t.data_ptr() for t in r._shadow_maps]}
            log(f"phase graph-path [{tag}]: poses {poses}; re-tune "
                f"{res['retune']}; dirty shadows {res['dirty_shadows']}")
            checks = poses + [res["retune"], res["dirty_shadows"]]
            if not all(c["equal"] and not any(c["counters"].values())
                       and not c.get("shadow_overflow") for c in checks) \
                    or any(any(p["eager_counters"].values()) for p in poses) \
                    or res["retune"]["captures"] != 1 \
                    or not res["retune"]["pair_budget"][1] > b0 \
                    or res["dirty_shadows"]["shadow_replays"] != 1 \
                    or not res["dirty_shadows"]["pack_kept"]:
                raise AssertionError(f"{tag}: a replayed frame differs from "
                                     f"its eager frame or counted over")
            if gcfg.texture_space:
                res["tss_bakes"] = tss_bake_checks(r)
            # warm frame ms, replayed against eager, alternating
            rep_ms, eag_ms = [], []
            for _ in range(10):
                for fn, acc in ((r.render, rep_ms), (r.render_eager, eag_ms)):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    acc.append((time.perf_counter() - t0) * 1e3)
            res["frame_ms"] = {"replayed_median": statistics.median(rep_ms),
                               "eager_median": statistics.median(eag_ms),
                               "replayed": rep_ms, "eager": eag_ms}
            # one frame each (the per-pixel frame is ~63k kernels, and the
            # profiler's own processing of them takes seconds); the app's
            # per-pixel eager frame is the default's with smaller maps
            res["profiler_replayed"] = prof_summary(
                profile_frame.profiled(r.render, 1, None))
            if tag != "app_per_pixel":
                res["profiler_eager"] = prof_summary(
                    profile_frame.profiled(r.render_eager, 1, None))
            res["loop"] = loop_vs_sequential(
                r, n=20 if tag == "tss_headline" else 5)
            res["programs"] = r.program_stats()
            log(f"phase graph-path [{tag}]: warm frame ms replayed "
                f"{res['frame_ms']['replayed_median']:.2f} vs eager "
                f"{res['frame_ms']['eager_median']:.2f} (median of 10 each, "
                f"alternating); replayed {res['profiler_replayed']}; eager "
                f"{res.get('profiler_eager')}; RenderLoop vs render() + "
                f".cpu() "
                f"{res['loop']}; {card}")
            graph_res[tag] = res
            del r, img, e_img
        graph_res["wall_s"] = time.time() - t_graph
        log(f"phase graph-path: {graph_res['wall_s']:.1f} s")
    except Exception as e:  # noqa: BLE001
        fail(phase, e)

    # phase: the app path, through the entry points a user calls:
    # engine.init(), then main_sample.main() in process on the Sponza at
    # 1920x1080 with the app's defaults (2048^2 shadow maps), per-pixel and
    # --textureSpace; an orbit with the HUD; the poll under the sync guard;
    # the re-tunes and the loop against sequential frames
    del scene
    torch.cuda.empty_cache()
    phase = "app-path"
    try:
        import tempfile

        from renderengine_tpu_torch.apps import main_sample
        from renderengine_tpu_torch.core import engine
        from renderengine_tpu_torch.tools import profile_frame, sync_sites
        from renderengine_tpu_torch.utils import png
        t_app = time.time()
        t0 = time.time()
        engine.init()
        app = {"engine_init_s": time.time() - t0,
               "device_info": engine.device_info()}
        app_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_app_"))
        orig_render = fr.FrameRenderer.render
        orig_poll = fr.FrameRenderer._poll_overflow

        def run_app(tag, extra, frames):
            """main_sample in process; every render() recorded: its
            renderer, the config it rendered with, its counters and its
            K1/K2 launches by shape. Before the second frame the check
            waits for the first (the app itself never does), so the
            first frame's counters are consumed before it."""
            calls = []

            def render(self, view_props=None):
                if len(calls) == 1:
                    torch.cuda.synchronize()
                before = dict(cr.variant_counts)
                p_before = dict(self.program_counts)
                img, st = orig_render(self, view_props)
                calls.append({"r": self, "cfg": self.config, "stats": st,
                              "renders": counts_delta(p_before,
                                                      self.program_counts),
                              "launches": {
                                  v: cr.variant_counts[v] - before.get(v, 0)
                                  for v in cr.variant_counts
                                  if cr.variant_counts[v] != before.get(v,
                                                                        0)}})
                return img, st

            def poll(self):
                # warm frames: the poll must not make the host wait
                if len(calls) >= 2:
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        return orig_poll(self)
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                return orig_poll(self)

            out = app_dir / f"{tag}.png"
            argv = ["--scenePath", "sponza", "--width", str(SPONZA_W),
                    "--height", str(SPONZA_H), "--frames", str(frames),
                    "--out", str(out)] + extra
            reset_counts()
            t0 = time.time()
            with mock.patch.object(fr.FrameRenderer, "render", render), \
                    mock.patch.object(fr.FrameRenderer, "_poll_overflow",
                                      poll):
                rc = main_sample.main(argv)
            torch.cuda.synchronize()
            wall = time.time() - t0
            if rc != 0 or len(calls) != frames:
                raise AssertionError(f"{tag}: rc {rc}, {len(calls)} renders")
            pngs = [png.read_png(str(out) if frames == 1 else
                                 str(out.with_suffix("")) + f"_{i:04d}.png")
                    for i in range(frames)]
            for im in pngs:
                if im.shape != (SPONZA_H, SPONZA_W, 4) or im.dtype != np.uint8:
                    raise AssertionError(f"{tag}: PNG {im.shape} {im.dtype}")
            counters = [{k: v.tolist() for k, v in c["stats"].items()}
                        for c in calls]
            log(f"phase app-path [{tag}]: {frames} frames in {wall:.1f} s "
                f"(scene load + renderer set-up included); launches by "
                f"frame {[{str(k): n for k, n in c['launches'].items()}
                          for c in calls]}; counters {counters}")
            return calls, pngs, counters, wall

        def overflow_free(st, r):
            return not (any(int(v) for k, v in st.items() if "overflow" in k)
                        or r.shadow_overflow)

        def check_frames(tag, calls, pngs, want_warm):
            """Launches per frame (``want_warm`` a replay, as many again
            for a capture's warm-up frame, the shadow maps' launches for a
            shadow replay or capture), each frame a replay of the
            captured frame program; no overflow from the second frame on;
            every frame from the second on equals render() with the config
            that frame used (the controller may re-tune between frames),
            byte for byte. Frames of different configs are held to each
            other at the golden bar (a shade-budget re-tune moves the
            peeled layer's aniso budget: ROADMAP F9)."""
            r = calls[-1]["r"]
            for i, c in enumerate(calls):
                want = expected_launches(want_warm, c["renders"],
                                         c["r"].n_shadows, shadow_v)
                if c["renders"]["frame_replays"] != 1:
                    raise AssertionError(f"{tag} frame {i}: renders "
                                         f"{c['renders']}")
                if c["launches"] != want:
                    raise AssertionError(f"{tag} frame {i}: launches "
                                         f"{c['launches']}, expected {want}")
                if i >= 1 and not overflow_free(c["stats"], r):
                    raise AssertionError(f"{tag} frame {i}: overflow after "
                                         f"the first counters")
            torch.cuda.synchronize()
            _, fst = r.render()          # the poll settles the config
            torch.cuda.synchronize()
            final_cfg = r.config
            r._react_overflow = False
            want_img = {}
            same = []
            for im, c in zip(pngs[1:], calls[1:]):
                if c["cfg"] not in want_img:
                    r.config = c["cfg"]
                    want_img[c["cfg"]] = r.render()[0].cpu().numpy()
                same.append(bool(np.array_equal(im, want_img[c["cfg"]])))
            r.config = final_cfg
            r._react_overflow = True
            final_same = [bool(c["cfg"] == final_cfg) for c in calls[1:]]
            n_diff = [int((im != pngs[-1]).any(-1).sum()) for im in pngs[1:]]
            frac, mx = goldens.golden_bar(pngs[1], pngs[-1])
            log(f"phase app-path [{tag}]: frames 2-{len(pngs)} identical to "
                f"render() with their own config: {same}; rendered with the "
                f"final config: {final_same}; pixels differing from the "
                f"last frame {n_diff}, frame 2 vs the last {frac:.6f} within"
                f" 1/255, max {mx}/255; {len(want_img)} configs")
            if not all(same) or not overflow_free(fst, r) or \
                    not goldens.meets_bar(frac, mx):
                raise AssertionError(f"{tag}: app frames differ from "
                                     f"render()")
            return r, {"same_as_render": same, "final_config": final_same,
                       "pixels_differing_from_last": n_diff,
                       "frame2_vs_last_bar": [frac, mx]}

        # the per-pixel app frame
        pp_calls, pp_pngs, pp_counters, pp_wall = run_app("per_pixel", [], 5)
        app_r, pp_check = check_frames("per-pixel", pp_calls, pp_pngs,
                                       {opaque_v: 1, peel_v: 1})
        app_cfg = app_r.config
        app["per_pixel"] = {"wall_s": pp_wall, "counters": pp_counters,
                            "frames": pp_check,
                            "shadow_extent": app_cfg.shadow_extent,
                            "launches": [{str(k): n for k, n in
                                          c["launches"].items()}
                                         for c in pp_calls],
                            "renders": [c["renders"] for c in pp_calls],
                            "programs": app_r.program_stats()}
        app_shadow_launches = sum(c["launches"].get(shadow_v, 0)
                                  for c in pp_calls)
        # the re-tunes: the budgets of frame 1 and after the first change
        first = pp_calls[0]["cfg"]
        later = next((c["cfg"] for c in pp_calls[1:]
                      if c["cfg"] != first), app_cfg)
        retune = {"frame1": {"blend_layer_tile_budgets":
                             list(first.blend_layer_tile_budgets),
                             "penumbra_tile_budget":
                             first.penumbra_tile_budget},
                  "after_first_change": {
                      "blend_layer_tile_budgets":
                      list(later.blend_layer_tile_budgets),
                      "penumbra_tile_budget": later.penumbra_tile_budget},
                  "final": {"blend_layer_tile_budgets":
                            list(app_cfg.blend_layer_tile_budgets),
                            "penumbra_tile_budget":
                            app_cfg.penumbra_tile_budget}}
        # the app's 2048^2 shadow launch is the one phase k1-shadow-2048
        # held to its plain version and timed: the same pair table
        asd = app_r.scene_dev
        au = torch.from_numpy(app_r.uniform_for_camera()).to(dev)
        s2 = fr.shadow_setup(asd, fr.unpack_params(au, app_r.n_shadows)[
            "shadow_viewproj"][sun2], app_cfg.shadow_extent)
        prep2 = cr.prepare_pairs(s2, e2, e2,
                                 max_pairs=app_r._shadow_budget_val)
        same2 = (app_cfg.shadow_extent == e2
                 and torch.equal(prep2.bins.counts, sh2_counts)
                 and torch.equal(prep2.pair_data[prep2.bins.pair_valid],
                                 sh2_live))
        log(f"phase app-path: the app's {e2}^2 map {sun2} has the pair "
            f"table timed in phase k1-shadow-2048: {same2}; "
            f"{app_shadow_launches} shadow launches on the app path")
        if not same2:
            raise AssertionError("the app's shadow launch is another shape")
        del prep2, s2, sh2_live, sh2_counts

        # the peel-shade span's kernel time at frame 1's config and at the
        # final one (the controller frozen while profiling)
        app_r._react_overflow = False
        for key, c in (("frame1", first), ("final", app_cfg)):
            app_r.config = c
            # the spans fire only while the pass chain is dispatched
            prof = profile_frame.profiled(app_r.render_eager, 1, None)
            retune[key]["peel_shade_ms"] = \
                prof["span_device_ms_per_frame"]["frame.peel_shade"]
            retune[key]["shade_ms"] = \
                prof["span_device_ms_per_frame"]["frame.shade"]
            retune[key]["wall_ms"] = prof["wall_ms_per_frame"]
        app_r.config = app_cfg
        app_r._react_overflow = True
        app["retune"] = retune
        log(f"phase app-path: re-tunes {retune}")
        # synchronizing calls a whole warm render() makes, and the frame
        # dispatched op by op: none (tools/sync_sites.py, each call's site)
        warm_sync = {"render": sync_sites.sync_sites(app_r.render),
                     "render_eager": sync_sites.sync_sites(
                         app_r.render_eager)}
        app["warm_render_sync_calls"] = warm_sync["render"]["calls"]
        app["warm_render_sync"] = warm_sync
        log(f"phase app-path: a warm render() makes "
            f"{warm_sync['render']['calls']} synchronizing calls, the eager "
            f"frame {warm_sync['render_eager']['calls']}: {warm_sync}")
        if warm_sync["render"]["calls"] or warm_sync["render_eager"]["calls"]:
            raise AssertionError("a warm render() synchronizes")

        app["loop_timing"] = {"per_pixel": loop_vs_sequential(app_r)}
        del app_r, pp_calls
        torch.cuda.empty_cache()

        # the texture-space app frame: one K2 launch a frame
        ts_calls, ts_pngs, ts_counters, ts_wall = run_app(
            "tss", ["--textureSpace"], 5)
        ts_r, ts_check = check_frames("texture-space", ts_calls, ts_pngs,
                                      {k2_v4: 1})
        app["tss"] = {"wall_s": ts_wall, "counters": ts_counters,
                      "frames": ts_check,
                      "launches": [{str(k): n for k, n in
                                    c["launches"].items()}
                                   for c in ts_calls]}
        app["loop_timing"]["tss"] = loop_vs_sequential(ts_r)
        del ts_r, ts_calls
        torch.cuda.empty_cache()

        # an orbit with the HUD: it runs, and once the counters of the
        # last view are consumed a frame there has no overflow
        ob_calls, ob_pngs, ob_counters, ob_wall = run_app(
            "orbit", ["--orbit", "--hud"], 8)
        ob_r = ob_calls[-1]["r"]
        torch.cuda.synchronize()
        ob_r.render()
        torch.cuda.synchronize()
        _, ob_st = ob_r.render()
        moved = not np.array_equal(ob_pngs[1], ob_pngs[-1])
        app["orbit"] = {"wall_s": ob_wall, "counters": ob_counters,
                        "moved": moved}
        log(f"phase app-path [orbit]: camera moved {moved}; counters after "
            f"growth {({k: v.tolist() for k, v in ob_st.items()})}")
        if not moved or not overflow_free(ob_st, ob_r):
            raise AssertionError("orbit: the camera did not move or the "
                                 "counters stayed over")
        del ob_r, ob_calls
        torch.cuda.empty_cache()

        # the browser viewer's entry point: three frames presented (PNG
        # encoded for the stream) on the card, then it stops
        from renderengine_tpu_torch.apps import live_viewer
        seen = []
        orig_present = live_viewer.LiveViewer._present

        def present(self, frame):
            seen.append(frame.shape)
            return orig_present(self, frame)

        reset_counts()
        t0 = time.time()
        with mock.patch.object(live_viewer.LiveViewer, "_present", present):
            rc = live_viewer.main(["--scenePath", "sponza", "--width",
                                   str(SPONZA_W), "--height", str(SPONZA_H),
                                   "--frames", "3", "--port", "0", "--fps",
                                   "0"])
        torch.cuda.synchronize()
        lv = {"rc": rc, "frames": len(seen), "wall_s": time.time() - t0,
              "k1_launches": cr.launch_counts["raster_tile"]}
        app["live_viewer"] = lv
        log(f"phase app-path [live_viewer]: {lv}")
        if rc != 0 or seen != [(SPONZA_H, SPONZA_W, 4)] * 3 or \
                lv["k1_launches"] < 6:
            raise AssertionError(f"live_viewer: {lv}, frames {seen}")
        app["loop_timing_note"] = ("wall ms a frame, 10 frames each, one "
                                   "renderer: RenderLoop (two frames in "
                                   "flight) vs render() + .cpu()")
        app["wall_s"] = time.time() - t_app
        log(f"phase app-path: loop vs sequential {app['loop_timing']}; "
            f"phase {app['wall_s']:.1f} s")
        for f in app_dir.iterdir():
            f.unlink()
        app_dir.rmdir()
    except Exception as e:  # noqa: BLE001
        fail(phase, e)

    # phase: the sharded renderer (parallel.sharded) on the one card: 2
    # ranks over gloo (NCCL puts no two ranks on one device; the gathers go
    # through host memory), spawned as processes, at 1920x1080 on the
    # Sponza, the default per-pixel config and the TSS headline, with the
    # single-card renderers' settled budgets; each gathered frame and the
    # sharded shadow maps must equal the single-card ones byte for byte.
    # Then a world of 1 over NCCL through the same code. Two processes
    # share one card: the frame times are a record, not a scaling claim
    phase = "sharded"
    try:
        import shutil
        import tempfile

        import torch.distributed as dist
        from renderengine_tpu_torch.tools import sharded_run

        t_sh = time.time()
        sponza = ("sponza_scene", dict(width=SPONZA_W, height=SPONZA_H))
        refs = {"per_pixel": pp_ref, "tss_headline": tss_ref}

        def sh_run(ref, frames):
            return {"scene": sponza, "config": ref["config"],
                    "backend": "cuda", "shadow_budget": ref["shadow_budget"],
                    "frames": frames, "keep_shadow_maps": True}

        def check(out, name, world):
            ref = refs[name]
            recs = [rk["runs"][name] for rk in out["ranks"]]
            frame = recs[0]["frame"]
            diff = int((frame != ref["frame"]).any(-1).sum())
            maps_eq = all(torch.equal(a, b) for a, b in
                          zip(recs[0]["shadow_maps"], ref["maps"]))
            over = [{k: v for k, v in r["stats"].items() if "overflow" in k}
                    | {"shadow_overflow": r["shadow_overflow"]}
                    for r in recs]
            res = {"world": world, "transport": out["ranks"][0]["transport"],
                   "frame_equal": diff == 0, "pixels_differ": diff,
                   "shadow_maps_equal": maps_eq,
                   "frame_ms": recs[0]["ms"],
                   "frame_ms_warm_median": statistics.median(
                       recs[0]["ms"][1:]),
                   "single_card_frame_ms": ref["frame_ms"],
                   "single_card_frame_ms_median": statistics.median(
                       ref["frame_ms"]),
                   "init_s": [r["init_s"] for r in recs],
                   "launches": [r["launches"] for r in recs],
                   "mode": [r["programs"]["mode"] for r in recs],
                   "sync_calls_warm_frame": [r["sync"]["calls"]
                                             for r in recs],
                   "counters": over}
            log(f"phase sharded [{name}, world {world}, "
                f"{res['transport']}]: {res}")
            want_mode = "captured" if res["transport"] == "nccl" else "eager"
            if diff or not maps_eq or any(any(o.values()) for o in over) \
                    or any(m != want_mode for m in res["mode"]):
                raise AssertionError(f"{name}: the sharded frame differs "
                                     f"from the single card's: {res}")
            return res

        sh_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_sharded_"))
        sharded_res = {}
        try:
            out = sharded_run.launch(
                {"dist_backend": "gloo", "world": 2,
                 "devices": ["cuda:0", "cuda:0"], "threads": 2,
                 "runs": {"per_pixel": sh_run(pp_ref, 3),
                          "tss_headline": sh_run(tss_ref, 3)}},
                sh_dir / "gloo", timeout_s=600)
            log(f"phase sharded: 2 ranks in {time.time() - t_sh:.1f} s, scene "
                f"build {[rk.get('scene_s') for rk in out['ranks']]} s")
            for name in refs:
                sharded_res[f"{name}_2"] = check(out, name, 2)
            # the band launch shapes were timed at rank 1's (y0 = 536)
            band_launches = {
                "raster_tile_band": out["ranks"][1]["runs"]["per_pixel"][
                    "launches"].get(str(opaque_v), 0),
                "raster_tile_peel2_band": out["ranks"][1]["runs"][
                    "per_pixel"]["launches"].get(str(peel_v), 0),
                "merged_tile_band": out["ranks"][1]["runs"]["tss_headline"][
                    "launches"].get(str(k2_v2), 0)}
            if not all(band_launches.values()):
                raise AssertionError(f"band launches {band_launches}")
            del out
            if not dist.is_nccl_available():
                raise AssertionError("this torch has no NCCL")
            # a world of 1 over NCCL: the band frame, the shadow pass and
            # the TSS bakes captured at init; warm frames under sync debug
            # mode "error", one more counted (0 calls), 2 replayed frames
            # against 2 eager in turns, and a shadow-dirty frame (one call,
            # the overflow read) equal to the warm frame
            t1 = time.time()
            nccl = {"sync_error": True, "eager_frames": 2, "dirty_frame": True}
            out = sharded_run.launch(
                {"dist_backend": "nccl", "world": 1, "devices": ["cuda:0"],
                 "threads": 2,
                 "runs": {"per_pixel": sh_run(pp_ref, 3) | nccl,
                          "tss_headline": sh_run(tss_ref, 3) | nccl}},
                sh_dir / "nccl", timeout_s=600)
            log(f"phase sharded: NCCL world 1 in {time.time() - t1:.1f} s")
            for name in refs:
                res = check(out, name, 1)
                rec = out["ranks"][0]["runs"][name]
                progs = rec["programs"]
                names = ["frame", "shadow"] + (
                    ["vis", "tables"] if name == "tss_headline" else [])
                res["captured"] = {
                    "mode": progs["mode"],
                    "programs": {n: progs.get(n) for n in names},
                    "replays": {n: progs[f"{n}_replays"] for n in names},
                    "sync_warm": rec["sync"], "sync_dirty": rec["sync_dirty"],
                    "eager_equal": rec["eager_equal"],
                    "dirty_equal": torch.equal(rec["frame_dirty"],
                                               rec["frame"]),
                    "dirty_counters": {k: v for k, v in
                                       rec["stats_dirty"].items()
                                       if "overflow" in k}
                    | {"shadow_overflow": rec["shadow_overflow_dirty"]}}
                res["frame_ms_replayed_vs_eager"] = {
                    "replayed": rec["replayed_ms"], "eager": rec["eager_ms"],
                    "replayed_median": statistics.median(rec["replayed_ms"]),
                    "eager_median": statistics.median(rec["eager_ms"]),
                    "single_card_replayed_median": graph_res[name][
                        "frame_ms"]["replayed_median"]}
                c = res["captured"]
                log(f"phase sharded [{name}, world 1, nccl, captured]: {c}; "
                    f"frame ms {res['frame_ms_replayed_vs_eager']}; {card}")
                if (c["mode"] != "captured"
                        or any(p is None or p["replays"] < 1
                               for p in c["programs"].values())
                        or any(progs[f"{n}_captures"] != 1 for n in names)
                        or c["sync_warm"]["calls"]
                        or c["sync_dirty"]["calls"] != 1
                        or not c["eager_equal"] or not c["dirty_equal"]
                        or any(c["dirty_counters"].values())):
                    raise AssertionError(f"{name}: the NCCL world of 1 did "
                                         f"not replay as expected: {c}")
                sharded_res[f"{name}_nccl_1"] = res
            del out
        finally:
            shutil.rmtree(sh_dir, ignore_errors=True)
        sharded_res["wall_s"] = time.time() - t_sh
        sharded_res["band_launches_rank1"] = band_launches
        log(f"phase sharded: {sharded_res['wall_s']:.1f} s; {card}; the "
            f"frame times of two ranks on one card are a record, not a "
            f"scaling claim")
    except Exception as e:  # noqa: BLE001
        fail(phase, e)

    def row(name, launches, err, ms, plain, bound, by, k2=False, pairs=None):
        t = times[name]
        return {"name": name, "route": "cuda",
                "source": SOURCE,
                "replaces": K2_REPLACES if k2 else REPLACES,
                "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                "library_ms": None, "in_graph_ms": t["in_graph_ms"],
                "densest_tile_ms": t["densest_tile_ms"],
                "launch_over_densest": t["launch_over_densest"],
                "device_ms": t["device_ms"], "host_ms": t["host_ms"],
                "pairs": pairs}

    def band_row(name, err_key, k2=False):
        b = band_rows[name]
        return row(name, band_launches[name], max_err[err_key],
                   times[name]["ms"], b["plain_ms"], b["bound"][0],
                   b["bound"][1], k2=k2, pairs=b["pairs"])

    kernels = [
        row("raster_tile", launches[opaque_v], max_err["opaque"], k1_ms,
            plain_ms, bound_ms, bound_by, pairs=pairs),
        row("raster_tile_shadow", launches[shadow_v], max_err["shadow"],
            sh_ms, sh_plain_ms, sh_bound_ms, sh_bound_by, pairs=sh_pairs),
        row("raster_tile_peel2", launches[peel_v], max_err["peel2"], pl_ms,
            pl_plain_ms, pl_bound_ms, pl_bound_by, pairs=pl_pairs),
        row("raster_tile_tss", path_launches["no_translucency"][k1_tss_v],
            max_err["tss"], ta_ms, ta_plain_ms, ta_bound, ta_by,
            pairs=pairs_a),
        row("raster_tile_tss_peel2",
            path_launches["factored"][k1_tss_peel_v], max_err["tss_peel2"],
            tp_ms, tp_plain_ms, tp_bound, tp_by, pairs=pairs_b),
        row("merged_tile", path_launches["headline"][k2_v2], max_err["k2_2"],
            k2[2]["ms"], k2[2]["plain_ms"], k2[2]["bound_ms"],
            k2[2]["bound_by"], k2=True, pairs=pairs_a + pairs_b),
        row("merged_tile_b4", path_launches["factored"][k2_v4],
            max_err["k2_4"],
            k2[4]["ms"], k2[4]["plain_ms"], k2[4]["bound_ms"],
            k2[4]["bound_by"], k2=True, pairs=pairs_a + pairs_b),
        row("raster_tile_shadow_2048", app_shadow_launches, err2, sh2_ms,
            sh2_plain_ms, sh2_bound_ms, sh2_bound_by, pairs=sh2_pairs),
        band_row("raster_tile_band", "band_opaque"),
        band_row("raster_tile_peel2_band", "band_peel2"),
        band_row("merged_tile_band", "band_k2", k2=True),
    ] + [row(name, b["launches"], b["err"], times[name]["ms"],
             b["plain_ms"], b["bound"][0], b["bound"][1],
             k2=name.startswith("merged"), pairs=b["pairs"])
         for name, b in ssaa2_rows.items()] + aniso_rows + peel_rows \
        + shade_rows + cube_rows
    for k in kernels:
        log(f"{k['name']}: {k['ms']!r} ms in this run, in a graph "
            f"{k['in_graph_ms']!r} ms, device "
            f"{k['device_ms']!r} ms, host {k['host_ms']!r} ms a call; one "
            f"block per tile, before the split walk (history, PERF.md): "
            f"{BEFORE_SPLIT_MS.get(k['name'])!r} ms")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"timings": {
        "k1_ms": k1_ms, "k1_plain_ms": plain_ms, "k1_bound_ms": bound_ms,
        "k1_bound_by": bound_by, "k1_densest_tile_ms": densest_ms,
        "densest_tile_pairs": max_count, "pairs": pairs, "tiles": n_tiles,
        "depth_wins": wins, "k1_ops": ops, "k1_bytes": bytes_moved,
        "shadow": {"ms": sh_ms, "plain_ms": sh_plain_ms,
                   "bound_ms": sh_bound_ms, "bound_by": sh_bound_by,
                   "pairs": sh_pairs, "tiles": sh_tiles,
                   "depth_wins": st_s["wins"], "ops": sh_ops,
                   "bytes": sh_bytes, "extent": e_sh, "maps": n_maps},
        "peel2": {"ms": pl_ms, "plain_ms": pl_plain_ms,
                  "bound_ms": pl_bound_ms, "bound_by": pl_bound_by,
                  "pairs": pl_pairs, "slots": n_sel,
                  "covered_tiles": covered_tiles,
                  "layer_entries": st_p["wins"],
                  "demotions": st_p["demotes"], "ops": pl_ops,
                  "bytes": pl_bytes},
        "frame_ms": frame_ms, "frame_ms_median_warm": statistics.median(
            frame_ms[1:]), "opaque_frame_ms": opaque_frame_ms,
        "opaque_frame_launches": opaque_launches,
        "launches_per_frame": [{str(k): v for k, v in pf.items()}
                               for pf in per_frame],
        "workspace_zeroings_per_frame": helpers,
        "memory": mem, "history_before_split_ms": BEFORE_SPLIT_MS,
        "history_before_split_frame_ms": BEFORE_SPLIT_FRAME_MS,
        "kernel_times": times,
        "sky_share": sky_share,
        "penumbra_tile_budget": rcfg.penumbra_tile_budget,
        "blend_tile_budget": rcfg.blend_tile_budget, "scene_tris": n_tris, "textures": n_tex,
        "tss": {"frame_ms": tss_ms, "launches_per_frame": tss_per_frame,
                "workspace_zeroings_per_frame": tss_helpers,
                "memory": tss_mem, "counters": tss_stats, "init_s": tss_init_s,
                "upload_bake_ms": bake_ms, "visibility_bake_ms": vis_ms,
                "spec_pass_ms": spec_ms, "tris": tss_tris,
                "atlas": [c_ah, c_aw], "live_texels": n_texels,
                "pairs_opaque": pairs_a, "pairs_blend": pairs_b,
                "k1_opaque": {"ms": ta_ms, "plain_ms": ta_plain_ms,
                              "bound_ms": ta_bound, "bound_by": ta_by,
                              "depth_wins": st_a["wins"], "ops": ta_ops,
                              "bytes": ta_bytes},
                "k1_dual_peel": {"ms": tp_ms, "plain_ms": tp_plain_ms,
                                 "bound_ms": tp_bound, "bound_by": tp_by},
                "k2": k2, "vs_per_pixel": vs_pp, "modes": modes,
                "launches_by_path": {
                    path: {str(k): v for k, v in c.items()}
                    for path, c in path_launches.items()}},
        "shadow_2048": {"ms": sh2_ms, "plain_ms": sh2_plain_ms,
                        "bound_ms": sh2_bound_ms, "bound_by": sh2_bound_by,
                        "pairs": sh2_pairs, "tiles": sh2_tiles,
                        "depth_wins": st2["wins"], "ops": sh2_ops,
                        "bytes": sh2_bytes,
                        "launches_app_path": app_shadow_launches},
        "graph": graph_res, "app": app, "sharded": sharded_res,
        "orbit": orbit_res, "ssaa2": ssaa2_res, "workspace": ws_res,
        "aniso": aniso_res, "tss_peel": peel_res, "tss_shade": shade_res,
        "cube": cube_res,
        "ssaa2_kernels": {k: {"ops": b["bound"][2], "bytes": b["bound"][3]}
                          for k, b in ssaa2_rows.items()},
        "width": SPONZA_W, "height": SPONZA_H, "card": card,
        "wall_s": time.time() - t_start}}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
