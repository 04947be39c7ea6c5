"""Device ms a replayed frame of the raster passes: the clock stamps of
``frame.merged_raster`` (K2), ``frame.raster`` (K1 opaque) and
``frame.peel_raster`` (K1's further peel layers) inside the replayed
frame program, the mean over the profiled window's frames. A program
that does not stamp these regions reads nothing."""

from portbench import frame_trace

REGIONS = ("frame.merged_raster", "frame.raster", "frame.peel_raster")


def read(readings):
    stamped = [r["device_ms"] for r in frame_trace.replayed()
               if r["device_ms"] is not None]
    if not all(set(REGIONS) <= d.keys() for d in stamped):
        return None
    return frame_trace.mean(sum(d[n] for n in REGIONS) for d in stamped)
