"""The comparison that decides ``correct``: presented frames of the
window against the plain reference (``reference/``), which rebuilds the
scene from the seed with its own generator and re-derives everything the
port derives at set-up.

The compared frames are drawn from the seed among the window's frames
whose counters report no dropped work; the reference drops nothing, so a
frame that dropped work without counting it differs from it.

Numbers compared, each with its limit (set from readings on the card,
see PERF.md):

- ``frame_off_gt1``: over the compared frames, the largest share of RGBA
  bytes that differ from the reference frame by more than 1 (of 255),
  against the nearest of its candidate images;
- ``overflow_share``: the share of the window's frames whose counters
  dropped work (an incomplete image: the controller grows the budget
  after the frame, and the frame is also counted in ``failed``);
- ``unpresented``: frames dispatched in the window and never presented;
- ``inputs_differ``: 1 if the port's scene generator and the reference's
  made different inputs from the seed.
"""

from __future__ import annotations

import gc

import numpy as np

FRAMES_COMPARED = 3
FRAMES_KEPT = 2 * FRAMES_COMPARED   # kept in the window, to draw from
# set from readings on the card (PERF.md): sound runs read at most 2.2e-4
# of bytes off and 0.8% of frames with dropped work; the control (the
# reference in bfloat16) reads 0.056 and more, a fault that drops work in
# every frame 1.0
LIMITS = {"frame_off_gt1": 0.005, "overflow_share": 0.05, "unpresented": 0,
          "inputs_differ": 0}


def off_share(a: np.ndarray, b: np.ndarray) -> float:
    """Share of bytes of two RGBA8 frames differing by more than 1."""
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return float((d > 1).mean())


def frame_off(frame: np.ndarray, candidates) -> float:
    """``off_share`` of a frame against the nearest of the reference's
    candidate images (torch tensors)."""
    return min(off_share(frame, c.cpu().numpy()) for c in candidates)


def reference_builder(builder: str):
    """The reference's scene builder of a configuration's
    ``scene.builder``: the function of that name in
    ``reference/scene/procedural.py``, else ``build`` of
    ``reference/scenes/<builder>.py`` (a plain copy of the port's builder
    of that name; see its README). An unknown name is a
    ``harness.CellError``."""
    from . import harness
    from .reference.scene import procedural

    fn = getattr(procedural, builder, None)
    if callable(fn):
        return fn
    path = harness.HERE / "reference" / "scenes" / f"{builder}.py"
    if path.is_file():
        return harness.load_file(
            path, f"portbench.reference.scenes.{builder}").build
    raise harness.CellError(
        f"no scene builder {builder!r} in reference/scene/procedural.py nor "
        f"a file reference/scenes/{builder}.py")


def reference_config(fields: dict):
    """The reference's ``RenderConfig`` from a configuration file's
    fields."""
    from .reference.core.config import RasterConfig, RenderConfig

    fields = dict(fields)
    raster = RasterConfig(**fields.pop("raster", {}))
    return RenderConfig(**fields, raster=raster)


def shadow_fit(rr, sched, cam, eye0, look0, i: int, fit0):
    """The shadow transforms of frame ``i``: fitted at the last frame that
    re-rendered the maps, or the scene's own camera's ``fit0``."""
    j = sched.last_dirty(i)
    if j is None:
        return fit0
    sched.apply(cam, eye0, look0, j)
    return rr.shadow_fit()


def pass_counts(rr, vp, cfg, fit) -> dict:
    """The work of one frame's raster passes at a pose, from the
    reference's own raster: per pass the covered fragments, the covered
    pixels per layer (``wins``), the valid triangles; the shadow maps'
    when the frame renders them."""
    import torch

    from .reference.core.config import CullMode
    from .reference.graph import frame as rf
    from .reference.graph.uniforms import unpack_params
    from .reference.raster.binned_raster import rasterize_binned

    u = rr.uniform(vp, fit)
    params = unpack_params(u, rr.n_shadows)
    sc = rr.scene_dev
    h, w = cfg.render_extent()

    def count(setup, hh, ww, bounds=None):
        c = {}
        g = rasterize_binned(setup, hh, ww, peel_bounds=bounds, counts=c)
        return g, c

    setup = rf._list_setup(sc, params, cfg, "corner_attr", "n_opaque",
                           cfg.cull_mode)
    g, c = count(setup, h, w)
    out = {"pixels": h * w,
           "opaque": {"fragments": int(c["fragments"]),
                      "wins": int((g.tri_id >= 0).sum()),
                      "triangles": c["triangles"]}}
    if cfg.translucency and rr.has_translucent:
        st = rf._list_setup(sc, params, cfg, "corner_attr_blend", "n_blend",
                            CullMode.NONE)
        prev = torch.full((h, w), -1.0, device=g.depth.device)
        g1, c1 = count(st, h, w, (prev, g.depth))
        prev = torch.where(g1.tri_id >= 0, g1.depth, 2.0)
        g2, _ = count(st, h, w, (prev, g.depth))
        out["blend"] = {"fragments": int(c1["fragments"]),
                        "wins": [int((g1.tri_id >= 0).sum()),
                                 int((g2.tri_id >= 0).sum())],
                        "triangles": c1["triangles"]}
    if rr.n_shadows:
        e = cfg.shadow_extent
        maps = []
        for si in range(rr.n_shadows):
            s = rf.triangle_setup_corners(
                rf.corner_clip(sc["corner_attr"][..., 0:3],
                               params["shadow_viewproj"][si]),
                sc["n_tris"], e, e, CullMode.FRONT)
            gs, cs = count(s, e, e)
            maps.append({"fragments": int(cs["fragments"]),
                         "wins": int((gs.tri_id >= 0).sum()),
                         "triangles": cs["triangles"]})
        out["shadow"] = maps
        out["shadow_pixels"] = e * e
    return out


def compare(*, sched, seed, builder, scene_kw, cfg_fields, kept, device,
            fingerprint, overflow_share, unpresented, control=False,
            count_poses=()) -> dict:
    """Render the reference frame of every kept window frame (by pose
    index) and hold the presented frame to it; with ``control`` also the
    control (the reference in bfloat16) at the same frames;
    ``count_poses`` also gives the raster passes' work at those pose
    indices (the traced run's roofline)."""
    import torch

    from . import harness
    from .reference.graph.frame import ReferenceRenderer
    from .reference.scene.camera import ViewProperties

    scene = reference_builder(builder)(seed=seed, **scene_kw)
    cam = scene.camera
    eye0 = np.asarray(cam.eye, np.float32).copy()
    look0 = np.asarray(cam.look_at, np.float32).copy()
    inputs_differ = int(harness.scene_fingerprint(scene, eye0)
                        != fingerprint)
    rcfg = reference_config(cfg_fields)
    rr = ReferenceRenderer(scene, rcfg, device)
    # the port fitted its first maps at the scene's own camera
    fit0 = rr.shadow_fit()

    def at(i):
        fit = shadow_fit(rr, sched, cam, eye0, look0, i, fit0)
        sched.apply(cam, eye0, look0, i)
        return ViewProperties.from_camera(cam), fit

    per_frame, ctrl = {}, {}
    for k in sorted(kept):
        vp, fit = at(k)
        refs = rr.render(vp, rcfg, fit)
        per_frame[k] = frame_off(np.asarray(kept[k]), refs)
        if control:
            low = rr.render(vp, rcfg, fit, lowp=True)[0]
            ctrl[k] = frame_off(low.cpu().numpy(), refs)
    counts = []
    for i in count_poses:
        vp, fit = at(i)
        counts.append(pass_counts(rr, vp, rcfg, fit))
    del rr
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    nums = {"frame_off_gt1": max(per_frame.values()) if per_frame else 1.0,
            "overflow_share": overflow_share, "unpresented": unpresented,
            "inputs_differ": inputs_differ}
    checks = {k: {"value": v, "limit": LIMITS[k]} for k, v in nums.items()}
    out = {"correct": all(v <= LIMITS[k] for k, v in nums.items()),
           "checks": checks, "per_frame": per_frame, "pass_counts": counts}
    if control:
        out["control"] = {"frame_off_gt1": max(ctrl.values()),
                          "per_frame": ctrl}
    return out
