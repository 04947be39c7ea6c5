"""K1's share (%) of its roofline over the profiled window: the sum of
each launch's bound (``kernels/k1.py`` counts, ``peaks.py`` peaks) over
the sum of its device time, from the profiler's records of
``raster_tile_kernel``. A launch's pass is read from its variant: peel
launches raster the translucent list, launches without attributes the
shadow maps, the others the opaque list. The passes' counts are the mean
over the poses the harness counted."""

from portbench import peaks
from portbench.kernels import k1


def _mean(dicts, key):
    return sum(d[key] for d in dicts) / len(dicts)


def read(readings):
    passes = readings.get("passes") or []
    recs = [(k1.variant(n), t) for n, t in readings["trace"]["raster"]]
    recs = [(v, t) for v, t in recs if v is not None]
    if not recs or not passes:
        return None
    bound = time = 0.0
    for (n_attrs, peel, dual), t in recs:
        if peel:
            ps = [p["blend"] for p in passes]
            wins = sum(sum(p["wins"][:2 if dual else 1])
                       for p in ps) / len(ps)
            px = passes[0]["pixels"]
        elif n_attrs == 0:
            ps = [m for p in passes for m in p["shadow"]]
            wins = _mean(ps, "wins")
            px = passes[0]["shadow_pixels"]
        else:
            ps = [p["opaque"] for p in passes]
            wins = _mean(ps, "wins")
            px = passes[0]["pixels"]
        ops, nbytes = k1.work(n_attrs, peel, dual, _mean(ps, "fragments"),
                              wins, _mean(ps, "triangles"), px)
        bound += peaks.bound_s(ops, nbytes)
        time += t
    return 100.0 * bound / time
