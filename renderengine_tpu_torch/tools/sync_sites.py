"""Where a warm frame makes the host wait on the card.

    python -m renderengine_tpu_torch.tools.sync_sites \
        [--width 1920] [--height 1080] [--tss | --app] [--dirty] \
        [--exposure]

Builds the procedural Sponza (260k triangles, 200 textures) with the
default per-pixel config (``--tss``: the texture-space headline config;
``--app``: the apps' per-pixel config, 2048^2 shadow maps), renders 4
frames with a synchronize after each (the overflow poll settles), then
one more ``render()`` under ``torch.cuda.set_sync_debug_mode("warn")``,
and, where the renderer has it, one ``render_eager()`` (the frame
dispatched op by op). ``--dirty`` adds a ``render()`` after
``mark_shadows_dirty()`` (the shadow pass, and with ``--tss`` the
visibility and table bakes), ``--exposure`` one at 1.5x the camera's
exposure (with ``--tss``, the table bake). For each synchronizing call it
records the port's innermost frames of the call's stack. Prints one JSON
line: per call, the number of synchronizing calls and the sites with
their counts, and the card's name and power limit. Needs a CUDA card;
exits non-zero without one.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import traceback
import warnings

import torch


def sync_sites(fn) -> dict:
    """Run ``fn()`` under ``set_sync_debug_mode("warn")``: the number of
    synchronizing calls it makes, and each call site as the port's three
    innermost stack frames (innermost first) with its count."""
    sites = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" not in str(message):
            return
        where = [f"{f.filename.rsplit('renderengine_tpu_torch', 1)[-1]}"
                 f":{f.lineno}" for f in traceback.extract_stack()
                 if "renderengine_tpu_torch" in f.filename
                 and not f.filename.endswith("sync_sites.py")]
        sites[" < ".join(reversed(where[-3:]))] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return {"calls": sum(sites.values()), "sites": dict(sites)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--tss", action="store_true",
                      help="the texture-space headline config")
    mode.add_argument("--app", action="store_true",
                      help="the apps' per-pixel config (2048^2 maps)")
    ap.add_argument("--dirty", action="store_true",
                    help="also a render() after mark_shadows_dirty()")
    ap.add_argument("--exposure", action="store_true",
                    help="also a render() at 1.5x the exposure")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sync_sites: needs a CUDA card", file=sys.stderr)
        sys.exit(2)

    from ..core.config import RenderConfig
    from ..graph.frame import FrameRenderer
    from ..scene import procedural
    from ..scene.camera import ViewProperties

    scene = procedural.sponza_scene(width=args.width, height=args.height)
    cfg = RenderConfig(width=args.width, height=args.height)
    if args.tss:
        cfg = cfg.replace(debug_views=False, texture_space=True,
                          tss_preshaded_blend=True, dither_trilinear=True,
                          sky_halfres=True)
    if args.app:
        cfg = cfg.replace(shadow_extent=2048)
    r = FrameRenderer(scene, cfg)
    for _ in range(4):
        r.render()
        torch.cuda.synchronize()
    out = {"card": subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(),
        "width": args.width, "height": args.height, "tss": args.tss,
        "app": args.app, "render": sync_sites(r.render)}
    if hasattr(r, "render_eager"):
        out["render_eager"] = sync_sites(r.render_eager)
    if args.exposure:
        vp = ViewProperties.from_camera(scene.camera)
        vp.exposure = float(vp.exposure) * 1.5
        out["render_exposure"] = sync_sites(lambda: r.render(vp))
        r.render()
    if args.dirty:
        r.mark_shadows_dirty()
        out["render_dirty"] = sync_sites(r.render)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
