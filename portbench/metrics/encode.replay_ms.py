"""Device ms a replayed frame of ``frame.encode``: the ``ssaa x ssaa``
box resolve of linear colour and the sRGB encode, from the clock stamps
inside the replayed frame program, the mean over the profiled window's
frames. A program that does not stamp the region reads nothing."""

from portbench import frame_trace

REGION = "frame.encode"


def read(readings):
    stamped = [r["device_ms"] for r in frame_trace.replayed()
               if r["device_ms"] is not None]
    if not all(REGION in d for d in stamped):
        return None
    return frame_trace.mean(d[REGION] for d in stamped)
