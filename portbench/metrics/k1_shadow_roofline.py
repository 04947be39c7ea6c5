"""K1's share (%) of its roofline over the depth-only launches of the
profiled window (the shadow maps: ``raster_tile_kernel`` without
attributes or peel bounds): the launches' summed bound over their summed
device time. The bound of one shadow pass is the sum over its maps of
each map's bound (``kernels/k1.py`` counts of that map, from the
benchmark's own raster at the poses the harness counted, their mean;
``peaks.py`` peaks), so a pass whose maps differ (a sun, a spot and a
point light's six cube faces) is counted map by map; the window's
launches make that many passes of ``n_maps`` launches each."""

from portbench import peaks
from portbench.kernels import k1


def read(readings):
    passes = [p for p in readings.get("passes") or [] if p.get("shadow")]
    times = [t for n, t in readings["trace"]["raster"]
             if k1.variant(n) == (0, False, False)]
    if not times or not passes:
        return None
    px = passes[0]["shadow_pixels"]
    per_pass = sum(
        peaks.bound_s(*k1.work(0, False, False, m["fragments"], m["wins"],
                               m["triangles"], px))
        for p in passes for m in p["shadow"]) / len(passes)
    n_maps = len(passes[0]["shadow"])
    return 100.0 * per_pass * len(times) / n_maps / sum(times)
