"""GPU smoke test of the PyTorch port (``renderengine_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds every kernel of the port's main path from the sources in the
checkout, holds each kernel against its plain PyTorch version on the card
(random triangles in every mode, then the three launch shapes of the main
path at full size: the opaque 1080p pass, the sun's 4096^2 depth-only
shadow pass, the dual-peel pass over the translucent list on the sparse
grid), renders the seven golden configs at their bar, then drives the main
path through the user entry point — ``FrameRenderer(scene,
RenderConfig(width=1920, height=1080)).render()``, the default
configuration (4096^2 shadow maps with 3x3 PCF, skybox, two depth-peeled
translucent layers, PBR with 16x tiered anisotropic sampling) on the
procedural Sponza (260k triangles, 200 textures of 512^2) — and checks its
output; the opaque-only frame of the first slice is still driven once.
Each phase is fatal: any failure exits non-zero without the final line.
Before the last line it prints the card's name and power limit (as
``nvidia-smi`` reports them), one JSON line of per-kernel numbers and one
of timings; the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Numbers: kernel times are medians of CUDA-event-timed launches at the main
path's shapes, plain-version times one CUDA-event-timed run; ``bound_ms``
is the larger of (bytes moved / 3.35 TB/s) and (operations / 67 TFLOP/s
FP32), counted from this run's inputs; frame times are host clock around
``render()`` followed by a synchronize.
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


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    d = (a.double() - b.double()).abs()
    return float(d.max()) if d.numel() else 0.0


def k1_plain_check(cr, prep, ntx, width, height, label, bounds=None,
                   tile_map=None, dual=False):
    """K1 against its plain version on the card over one pair table:
    depth, tri and material planes of every layer bit-exact; attribute
    planes within 1e-6 (absolute, on values of at most a few hundred).
    Returns (max abs error, the plain run's stats: (pair, pixel) fragments
    that entered a layer and layer-1 demotions, the plain run's ms)."""
    b = prep.bins
    args = (prep.pair_data, b.starts, b.counts, ntx, width, height, 0,
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
        from renderengine_tpu_torch.raster import cuda_raster as cr
        from renderengine_tpu_torch.raster.setup import triangle_setup
        from renderengine_tpu_torch.scene import procedural
        from renderengine_tpu_torch.tools import goldens
        t0 = time.time()
        so = cr.build()
        ptxas = [ln.strip() for ln in so.with_suffix(".log").read_text()
                 .splitlines() if "registers" in ln or "spill" in ln]
        log(f"phase build: {so.name} in {time.time() - t0:.1f} s")
        for ln in ptxas:
            log(f"  ptxas: {ln}")
    except Exception as e:  # noqa: BLE001 — every phase is fatal
        fail(phase, e)

    def reset_counts():
        for k in cr.launch_counts:
            cr.launch_counts[k] = 0
        cr.variant_counts.clear()

    # phase 2: K1 against its plain version on random triangles, in every
    # mode: single winner, peel, dual, each on the dense and a sparse grid
    phase = "k1-random"
    max_err = {"opaque": 0.0, "shadow": 0.0, "peel2": 0.0}
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
            for n_attrs in (0, 8):
                ap = None
                if n_attrs:
                    ap = cr.attribute_planes(s, torch.from_numpy(
                        rng.uniform(-5, 5, (n, 3, 8)).astype(np.float32)
                    ).to(dev))
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
                        max_err[key] = max(max_err[key], err)
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
        k1_ms = cuda_ms(lambda: cr.raster_tiles(*args, n_attrs=8), 30)
        # the densest tile alone: the serial floor of one block per tile
        solo = torch.zeros_like(b.counts)
        dense_tile = int(b.counts.argmax())
        solo[dense_tile] = b.counts[dense_tile]
        solo_args = (prep.pair_data, b.starts, solo, ntx, SPONZA_W, SPONZA_H)
        densest_ms = cuda_ms(lambda: cr.raster_tiles(*solo_args, n_attrs=8),
                             30)
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
        sh_ms = cuda_ms(lambda: cr.raster_tiles(*sh_args, n_attrs=0), 10)
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
        pl_ms = cuda_ms(lambda: cr.raster_tiles(*pl_args), 30)
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
        frame_ms, per_frame = [], []
        for _ in range(N_FRAMES):
            before = dict(cr.variant_counts)
            t0 = time.perf_counter()
            img, stats = renderer.render()
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            per_frame.append({v: cr.variant_counts[v] - before.get(v, 0)
                              for v in (opaque_v, shadow_v, peel_v)})
        total = cr.launch_counts["raster_tile"]
        launches = {v: cr.variant_counts[v]
                    for v in (opaque_v, shadow_v, peel_v)}
        log(f"phase main-path: {total} launches {per_frame}, "
            f"frame ms {frame_ms}")
        for i, pf in enumerate(per_frame):
            want = {opaque_v: 1, peel_v: 1, shadow_v: n_maps if i == 0 else 0}
            if pf != want:
                raise AssertionError(f"frame {i}: K1 launches {pf}, "
                                     f"expected {want}")
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
        # the same frame with K1 swapped for its plain version on the card
        # (the cached shadow maps stay: phase k1-shadow held that launch)
        with mock.patch.object(cr, "raster_tiles", cr._raster_tiles_plain):
            ref, _ = renderer.render()
        frac, mx = goldens.golden_bar(img_np, ref.cpu().numpy())
        log(f"phase main-path: vs plain-K1 frame {frac:.6f} within 1/255, "
            f"max {mx}/255")
        if not goldens.meets_bar(frac, mx):
            raise AssertionError("K1 frame misses the bar against plain K1")
    except Exception as e:  # noqa: BLE001
        fail(phase, e)

    def row(name, launches, err, ms, plain, bound, by):
        return {"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bound, "bound_by": by, "library_ms": None}

    kernels = [
        row("raster_tile", launches[opaque_v], max_err["opaque"], k1_ms,
            plain_ms, bound_ms, bound_by),
        row("raster_tile_shadow", launches[shadow_v], max_err["shadow"],
            sh_ms, sh_plain_ms, sh_bound_ms, sh_bound_by),
        row("raster_tile_peel2", launches[peel_v], max_err["peel2"], pl_ms,
            pl_plain_ms, pl_bound_ms, pl_bound_by),
    ]
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
        "sky_share": sky_share,
        "penumbra_tile_budget": rcfg.penumbra_tile_budget,
        "blend_tile_budget": rcfg.blend_tile_budget, "scene_tris": n_tris, "textures": n_tex,
        "width": SPONZA_W, "height": SPONZA_H, "card": card,
        "wall_s": time.time() - t_start}}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
