#!/usr/bin/env python
"""Benchmark of the PyTorch port (``renderengine_tpu_torch``): the
procedural Sponza at 1920x1080 on one card, measured as the JAX
package's ``bench.py`` measures it.

    python3 bench_torch.py [--quick] [--frames N] [--rounds R]
                           [--width W --height H] [--per-pixel |
                           --texture-space] [--no-extras] [--budget S]
                           [--goldens] [--device DEV] [scene and config
                           flags, see --help]

Progress goes to stderr. On stdout the cumulative record is printed as one
JSON line after each mode, so a run that is cut still leaves a whole
record; the last line is the full record:

  {"metric": "frame_ms_1080p_sponza", "value": <fixed-pose warm median ms
   of the first mode>, "unit": "ms", "modes": {"per_pixel": {...},
   "tss_headline": {...}, "tss_headline_ssaa2": {...}},
   "golden_gate": {...}, "card": ..., ...}

The golden gate rides every record: the seven golden configs rendered
through ``FrameRenderer`` on the device, against ``tests/goldens_torch/``
(or the JAX package's ``tests/goldens/`` for ``cube_phong``), at the
golden bar (within 1/255 on >= 99.9% of pixels, max 4/255), with every
overflow counter 0. A red gate exits 1 after the record is printed.

Modes: ``per_pixel`` is the default ``RenderConfig`` (4096^2 shadow maps,
3x3 PCF, skybox, two peeled translucent layers, PBR with 16x tiered
anisotropic sampling); ``tss_headline`` the texture-space headline
(``texture_space``, ``tss_preshaded_blend``, ``dither_trilinear``,
``sky_halfres``); ``tss_headline_ssaa2`` the headline at ``ssaa=2``
(3840x2160 inside, box-resolved to 1920x1080). ``--per-pixel`` runs
``per_pixel`` and ``per_pixel_ssaa2``, ``--texture-space`` the two TSS
modes, ``--no-extras`` the first mode alone. The per-pixel and ssaa2
modes run ``max(8, frames // 2)`` frames, the headline ``frames``
(``--quick``: ``frames`` in every mode).

Each mode's renderer (its budgets its own: estimated at init, grown and
re-tuned by its poll) draws one frame (the shadow pass and, with
texture-space shading, the visibility bake), then:
- fixed pose: its frames at the scene's camera, each timed on the host
  clock around ``render()`` and a synchronize; ``frame_ms_median`` (and
  ``value``, of the first mode) is their median;
- orbit (``modes.<tag>.orbit``), as ``bench.py`` does it: frame ``i`` of
  an orbit turns the eye 0.02 * i rad about the world's +y axis (look_at
  stays). Settling: up to 4 whole orbits, stopping after the first in
  which the renderer's config did not change (on the card: no recapture
  of the frame program) once the poll has taken in the counters of all
  its frames (``bench.py`` compares before the last frames' counters
  are read, so an overflow near an orbit's end lands in a timed round); ``settle_orbits``, ``settled`` and
  ``settle_recaptures`` record it, and a renderer that never settles is
  recorded so and measured all the same. Then ``--rounds`` timed rounds:
  each renders the orbit's frames with no synchronize between them,
  keeping the images, and synchronizes once after the last; ``fps`` is
  frames / best round, ``fps_median_round`` frames / median round. A
  round deeper than the renderer's poll queue (``FrameRenderer.
  _MAX_PENDING``, 16 frames) waits in the poll on the oldest frame, so
  such a round is paced by the device, like ``bench.py``'s.
  ``recaptures_timed`` counts frame captures during the rounds, and
  ``last_round_counters`` holds the last frame's overflow counters.

On a CUDA device each warm frame is a replay of the frame program the
renderer captured into a CUDA graph (at init, and again after a budget
change); on the CPU the pass chain runs eagerly. ``config_divergence``
lists every way a mode's config departs from the reference's constants,
in ``bench.py``'s words. ``--quick`` cuts the scene (5000 triangles, 16
textures, 256^2 shadow maps) and the frame to 320x240 unless flags say
otherwise, and holds the ``cuda`` backend against the ``reference``
backend on the device at orbit pose 0 in every mode: more than 1% of
bytes differing by more than 2 exits 1. ``vs_baseline`` is fps / 60, the
reference's design target (BASELINE.md), recorded as measured: it is not
compared with the JAX package's TPU records. ``--budget`` (seconds) skips
each mode after the first that would not fit, recording ``{"skipped":
...}``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time

# seconds a mode is expected to take at full size on the card, for the
# --budget check of every mode after the first
MODE_EST_S = {"per_pixel": 240.0, "tss_headline": 90.0,
              "tss_headline_ssaa2": 180.0, "per_pixel_ssaa2": 600.0}
SETTLE_ORBITS = 4
ORBIT_STEP = 0.02      # rad a frame (bench.py)


def card_line(device) -> str | None:
    """The card's name and power limit as nvidia-smi reports them."""
    if device.type != "cuda":
        return None
    idx = device.index or 0
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(idx),
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def overflow_counters(stats: dict) -> dict:
    return {k: int(v) for k, v in stats.items() if "overflow" in k}


class Orbit:
    """``bench.py``'s orbiting camera over ``scene.camera``: pose ``i``
    turns the starting eye ``ORBIT_STEP * i`` rad about the world's +y
    axis, look_at fixed. ``restore()`` puts the starting view back."""

    def __init__(self, camera):
        import numpy as np

        self.cam = camera
        self.eye0 = np.asarray(camera.eye, np.float32).copy()
        self.up = np.array([0, 1, 0], np.float32)

    def vp(self, i: int):
        import numpy as np

        from renderengine_tpu_torch.scene.camera import ViewProperties

        ang = ORBIT_STEP * i
        e = self.eye0
        self.cam.set_camera_view(
            np.array([e[0] * np.cos(ang) - e[2] * np.sin(ang), e[1],
                      e[0] * np.sin(ang) + e[2] * np.cos(ang)], np.float32),
            self.cam.look_at, self.up)
        return ViewProperties.from_camera(self.cam)

    def restore(self) -> None:
        self.cam.set_camera_view(self.eye0, self.cam.look_at, self.up)


def frame_captures(r) -> int:
    return r.program_counts.get("frame_captures", 0)


def settle(r, orbit: Orbit, frames: int, device,
           max_orbits: int = SETTLE_ORBITS) -> dict:
    """Whole orbits until one leaves the renderer's config (and so its
    frame program) as it found it once its frames' counters are all
    taken in, at most ``max_orbits``."""
    caps0 = frame_captures(r)
    changed = []
    for _ in range(max_orbits):
        cfg0, c0 = r.config, frame_captures(r)
        for i in range(frames):
            r.render(orbit.vp(i))
        sync(device)
        if r._react_overflow:
            # the poll takes a frame's counters in at a later render():
            # take this orbit's last ones in now, so that an overflow near
            # its end counts against it and not against a timed round
            r._poll_overflow()
        changed.append(r.config != cfg0 or frame_captures(r) != c0)
        if not changed[-1]:
            break
    return {"settle_orbits": len(changed), "settled": not changed[-1],
            "settle_recaptures": frame_captures(r) - caps0,
            "settle_config_changed": changed}


def timed_rounds(r, orbit: Orbit, frames: int, rounds: int, device) -> dict:
    """``rounds`` rounds of the orbit's frames, each dispatched with no
    synchronize in between and synchronized once after its last frame."""
    caps0 = frame_captures(r)
    round_ms, imgs = [], []
    for _ in range(rounds):
        sync(device)
        imgs = []
        t0 = time.perf_counter()
        for i in range(frames):
            imgs.append(r.render(orbit.vp(i)))
        sync(device)
        round_ms.append((time.perf_counter() - t0) * 1e3)
    best = min(round_ms)
    return {"frames": frames, "rounds": rounds, "round_ms": round_ms,
            "best_round_ms": best, "fps": frames / (best / 1e3),
            "fps_median_round": frames / (statistics.median(round_ms) / 1e3),
            "recaptures_timed": frame_captures(r) - caps0,
            "last_round_counters": overflow_counters(imgs[-1][1]),
            "frames_0_1_differ": (bool((imgs[0][0] != imgs[1][0]).any())
                                  if frames > 1 else None)}


def config_divergence(cfg) -> str:
    """Every way ``cfg`` departs from the reference's own constants, in
    ``bench.py``'s words."""
    div = []
    if cfg.shadow_extent != 4096:
        # reference constant: 4096^2 shadow maps (RenderScene.cpp:26)
        div.append(f"shadow_extent={cfg.shadow_extent} "
                   "(reference constant 4096)")
    if cfg.max_anisotropy < 16:
        # reference requests the device max, 16x (TextureCache.cpp:185)
        div.append(f"max_anisotropy={cfg.max_anisotropy} "
                   "(reference sampler requests 16)")
    elif cfg.dither_trilinear:
        div.append("aniso=16x Bayer-distributed single taps "
                   "(reference: dense 16-tap footprint)")
    elif cfg.aniso_tile_fracs:
        div.append(f"aniso=16x exact taps on tiered tile budgets "
                   f"{tuple(cfg.aniso_tile_fracs)} (isotropic-trilinear "
                   "fallback past budget; reference: dense 16-tap)")
    if cfg.dither_trilinear:
        div.append("mip_filter=dithered (reference: two-tap trilinear)")
    if cfg.sky_halfres:
        div.append("sky=half-grid sampled (reference: per-pixel)")
    if cfg.texture_space:
        div.append("shading=texture-space charts "
                   "(reference: per-pixel fragment shading)")
    return "; ".join(div)


def golden_gate_record(device) -> dict:
    """The seven golden configs through ``FrameRenderer`` on ``device``
    against their goldens, at the golden bar, every counter 0."""
    from renderengine_tpu_torch.graph.frame import FrameRenderer
    from renderengine_tpu_torch.tools import goldens

    worst = {"name": None, "frac": 1.0, "max": 0}
    failed = []
    sets = set()
    for name, factory, cfg in goldens.golden_cases():
        r = FrameRenderer(factory(), cfg, device=device, backend="cuda")
        img, st = r.render()
        frac, mx = goldens.golden_bar(img.cpu().numpy(),
                                      goldens.load_golden(name))
        over = sum(overflow_counters(st).values()) + r.shadow_overflow
        sets.add(goldens.golden_path(name).parent.name)
        print(f"# golden {name}: {frac:.6f} within 1/255, max {mx}, "
              f"overflow {over}", file=sys.stderr)
        if frac < worst["frac"] or mx > worst["max"]:
            worst = {"name": name, "frac": min(frac, worst["frac"]),
                     "max": max(mx, worst["max"])}
        if not goldens.meets_bar(frac, mx) or over:
            failed.append({"name": name, "frac_within_1": frac,
                           "max_diff": mx, "overflow": over})
    rec = {"pass": not failed, "backend": "cuda",
           "golden_sets": sorted(sets),
           "worst_frac_within_1": worst["frac"],
           "worst_max_diff": worst["max"]}
    if failed:
        rec["failed"] = failed
    return rec


def parity_record(r, scene, cfg, orbit: Orbit, device) -> dict:
    """``bench.py --quick``'s hardware parity check: the renderer's
    ``cuda`` frame against a ``reference``-backend renderer's on the same
    device at orbit pose 0; more than 1% of bytes differing by more than
    2 fails."""
    import torch

    from renderengine_tpu_torch.graph.frame import FrameRenderer

    # the reference renderer is made at pose 0, the view ``r`` was made
    # at: texture-space charts are laid out from the camera at init
    vp0 = orbit.vp(0)
    r_ref = FrameRenderer(scene, cfg, device=device, backend="reference")
    a = r.render(vp0)[0].cpu().to(torch.int16)
    b = r_ref.render(vp0)[0].cpu().to(torch.int16)
    bad = float(((a - b).abs() > 2).float().mean())
    return {"backends": ["cuda", "reference"], "bytes_differ_gt2": bad,
            "pass": bad <= 0.01}


def measure(scene, cfg, frames: int, rounds: int, device, tag: str,
            parity: bool = False) -> dict:
    """One renderer: the first frame, ``frames`` fixed-pose warm frames
    (each timed around ``render()`` + synchronize), the orbit's settling
    and its ``rounds`` timed rounds; with ``parity`` the device parity
    check between them."""
    import torch

    from renderengine_tpu_torch.graph.frame import FrameRenderer

    cuda = device.type == "cuda"
    t_mode = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    r = FrameRenderer(scene, cfg, device=device)
    sync(device)
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r.render()
    sync(device)
    first_ms = (time.perf_counter() - t0) * 1e3
    ms, st = [], None
    for _ in range(frames):
        t0 = time.perf_counter()
        img, st = r.render()
        sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(ms)
    out = {"frame_ms_median": med, "frame_ms": ms, "fps": 1e3 / med,
           "first_frame_ms": first_ms, "init_s": init_s,
           "last_frame_counters": overflow_counters(st),
           "frame_shape": list(img.shape), "ssaa": cfg.ssaa,
           "render_extent": list(cfg.render_extent()),
           "config_divergence": config_divergence(cfg)}
    print(f"# [{tag}] {cfg.width}x{cfg.height} (ssaa {cfg.ssaa}): init "
          f"{init_s:.2f} s, first frame {first_ms:.1f} ms, fixed-pose warm "
          f"median {med:.2f} ms over {frames}, counters "
          f"{out['last_frame_counters']}", file=sys.stderr)
    orbit = Orbit(scene.camera)
    try:
        orb = settle(r, orbit, frames, device)
        print(f"# [{tag}] orbit settling: {orb}", file=sys.stderr)
        if parity:
            out["parity"] = parity_record(r, scene, cfg, orbit, device)
            print(f"# [{tag}] device parity cuda vs reference: "
                  f"{out['parity']}", file=sys.stderr)
        orb.update(timed_rounds(r, orbit, frames, rounds, device))
    finally:
        orbit.restore()
    out["orbit"] = orb
    print(f"# [{tag}] orbit: best round {orb['best_round_ms']:.1f} ms = "
          f"{orb['fps']:.3f} FPS, rounds {orb['round_ms']}, recaptures "
          f"timed {orb['recaptures_timed']}, counters "
          f"{orb['last_round_counters']}", file=sys.stderr)
    ps = r.program_stats()
    out["programs"] = {k: v for k, v in ps.items()
                       if k.endswith(("_captures", "_replays"))}
    out["programs"]["pool_bytes"] = {
        k: v["pool_bytes"] for k, v in ps.items()
        if isinstance(v, dict) and "pool_bytes" in v}
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(device) if cuda
                         else None)
    out["wall_s"] = time.perf_counter() - t_mode
    print(f"# [{tag}] peak device memory {out['peak_bytes']} B, "
          f"{out['wall_s']:.1f} s", file=sys.stderr)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="small scene and frame, and the device parity "
                    "check (a sanity run, not the headline number)")
    ap.add_argument("--frames", type=int, default=30,
                    help="frames of the fixed pose and of an orbit (the "
                    "per-pixel and ssaa2 modes: max(8, frames // 2))")
    ap.add_argument("--rounds", type=int, default=3,
                    help="timed orbit rounds per mode")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--per-pixel", action="store_true",
                    help="only the per-pixel configuration (and its ssaa2 "
                    "mode)")
    ap.add_argument("--texture-space", action="store_true",
                    help="only the texture-space headline (and its ssaa2 "
                    "mode)")
    ap.add_argument("--no-extras", action="store_true",
                    help="only the first mode")
    ap.add_argument("--budget", type=float, default=1500.0,
                    help="wall-clock seconds: a mode after the first that "
                    "would not fit is recorded as skipped")
    ap.add_argument("--goldens", action="store_true",
                    help="only the golden gate")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--shadow-extent", type=int, default=None,
                    help="shadow map extent (default 4096, the reference's "
                    "constant; --quick 256)")
    ap.add_argument("--tris", type=int, default=None,
                    help="scene triangles (default 260000; --quick 5000)")
    ap.add_argument("--textures", type=int, default=None,
                    help="scene textures (default 200; --quick 16)")
    ap.add_argument("--tex-size", type=int, default=None,
                    help="texture resolution (default: the scene's, 512 at "
                    "bench scale)")
    ap.add_argument("--pairs-per-tri", type=int, default=4)
    ap.add_argument("--no-translucency", action="store_true")
    ap.add_argument("--preshaded", action="store_true",
                    help="texture-space modes: fully pre-shaded charts")
    ap.add_argument("--preshaded-blend", action="store_true",
                    help="texture-space modes: pre-shade only the "
                    "translucent peels (their default)")
    ap.add_argument("--dither", action="store_true", default=None,
                    help="dithered trilinear (default in the texture-space "
                    "modes; with --per-pixel, in the per-pixel modes)")
    ap.add_argument("--no-dither", action="store_true")
    ap.add_argument("--chart-density", type=float, default=0.5)
    ap.add_argument("--chart-budget", type=int, default=2_000_000)
    return ap


def mode_configs(args, w: int, h: int, extent: int) -> dict:
    """The modes to run, in order, with their configs."""
    from renderengine_tpu_torch.core.config import RasterConfig, RenderConfig

    base = dict(width=w, height=h, shadow_extent=extent,
                translucency=not args.no_translucency,
                raster=RasterConfig(pairs_per_tri=args.pairs_per_tri))
    dither = None if args.no_dither else args.dither
    pp = RenderConfig(**base, dither_trilinear=bool(
        args.per_pixel and dither))
    tss = RenderConfig(
        **base, debug_views=False, texture_space=True,
        tss_preshaded=args.preshaded,
        tss_preshaded_blend=args.preshaded_blend or not args.preshaded,
        dither_trilinear=dither is not False, sky_halfres=True,
        chart_density=args.chart_density, chart_budget=args.chart_budget)
    if args.per_pixel:
        modes = {"per_pixel": pp, "per_pixel_ssaa2": pp.replace(ssaa=2)}
    elif args.texture_space:
        modes = {"tss_headline": tss,
                 "tss_headline_ssaa2": tss.replace(ssaa=2)}
    else:
        modes = {"per_pixel": pp, "tss_headline": tss,
                 "tss_headline_ssaa2": tss.replace(ssaa=2)}
    if args.no_extras:
        modes = dict([next(iter(modes.items()))])
    return modes


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    t_start = time.time()
    deadline = t_start + args.budget

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    from renderengine_tpu_torch.core.config import RenderConfig
    from renderengine_tpu_torch.device import resolve_device
    from renderengine_tpu_torch.scene import procedural

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = {"metric": "golden_gate" if args.goldens
           else "frame_ms_1080p_sponza" if not args.quick
           else "frame_ms_quick", "unit": "pass" if args.goldens else "ms",
           "device": str(device), "card": card_line(device),
           "torch": torch.__version__, "cuda": torch.version.cuda}
    gate = golden_gate_record(device)
    rec["golden_gate"] = gate
    if args.goldens:
        rec["value"] = 1.0 if gate["pass"] else 0.0
        print(json.dumps(rec), flush=True)
        return 0 if gate["pass"] else 1

    if args.quick:
        w, h = args.width or 320, args.height or 240
        tris, textures, extent = 5000, 16, 256
    else:
        w, h = args.width or 1920, args.height or 1080
        tris, textures = 260_000, 200
        extent = RenderConfig().shadow_extent
    tris = args.tris or tris
    textures = args.textures or textures
    extent = args.shadow_extent or extent
    t0 = time.perf_counter()
    scene = procedural.sponza_scene(width=w, height=h, n_textures=textures,
                                    target_tris=tris, tex_size=args.tex_size)
    rec["scene_s"] = time.perf_counter() - t0
    rec["scene"] = {"target_tris": tris, "textures": textures,
                    "tex_size": args.tex_size}
    rec["width"], rec["height"] = w, h
    rec["rounds"] = args.rounds
    rec["baseline"] = ("fps / 60, the reference's design target "
                       "(BASELINE.md); recorded as measured, not a target")
    rec["modes"] = {}
    rc = 0 if gate["pass"] else 1
    for n, (tag, cfg) in enumerate(mode_configs(args, w, h, extent).items()):
        frames = (args.frames if args.quick or tag == "tss_headline"
                  else max(8, args.frames // 2))
        left = deadline - time.time()
        est = MODE_EST_S.get(tag, 300.0)
        if n and left < est:
            rec["modes"][tag] = {"skipped": f"timeout ({left:.0f}s left < "
                                            f"~{est:.0f}s)"}
        elif n == 0:
            rec["modes"][tag] = measure(scene, cfg, frames, args.rounds,
                                        device, tag, parity=args.quick)
            first = rec["modes"][tag]
            rec["value"] = first["frame_ms_median"]
            rec["value_mode"] = tag
            rec["vs_baseline"] = first["fps"] / 60.0
        else:
            try:
                rec["modes"][tag] = measure(scene, cfg, frames, args.rounds,
                                            device, tag, parity=args.quick)
            except Exception as e:  # noqa: BLE001 — recorded, and rc 1
                rec["modes"][tag] = {"error": f"{type(e).__name__}: {e}"
                                     [:300]}
                rc = 1
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        rec["wall_s"] = time.time() - t_start
        print(json.dumps(rec), flush=True)
        par = rec["modes"][tag].get("parity")
        if par is not None and not par["pass"]:
            print(f"# PARITY FAILURE [{tag}]: {par['bytes_differ_gt2']:.2%} "
                  "of bytes differ cuda vs reference on the device",
                  file=sys.stderr)
            return 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
