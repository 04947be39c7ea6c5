"""K2's share (%) of its roofline over the profiled window: the sum of
each launch's bound (``kernels/k2.py`` counts, ``peaks.py`` peaks) over
the sum of its device time, from the profiler's records of
``merged_tile_kernel``. The passes' counts are the mean over the poses
the harness counted."""

from portbench import peaks
from portbench.kernels import k2


def read(readings):
    passes = [p for p in readings.get("passes") or [] if "blend" in p]
    recs = [(k2.variant(n), t) for n, t in readings["trace"]["raster"]]
    recs = [(v, t) for v, t in recs if v is not None]
    if not recs or not passes:
        return None
    n = len(passes)
    opaque = {k: sum(p["opaque"][k] for p in passes) / n
              for k in ("fragments", "wins", "triangles")}
    blend = {"fragments": sum(p["blend"]["fragments"] for p in passes) / n,
             "wins": sum(sum(p["blend"]["wins"]) for p in passes) / n,
             "triangles": sum(p["blend"]["triangles"] for p in passes) / n}
    bound = time = 0.0
    for (nab,), t in recs:
        ops, nbytes = k2.work(nab, opaque, blend, passes[0]["pixels"])
        bound += peaks.bound_s(ops, nbytes)
        time += t
    return 100.0 * bound / time
