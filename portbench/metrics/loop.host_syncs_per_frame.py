"""Host waits on the device a frame: the renderer's count of calls that
block on device work other than a presented frame's copy (the shadow
pass's overflow read, a forced wait of the counters' poll), the mean over
the profiled window's replayed frames."""

from portbench import frame_trace


def read(readings):
    return frame_trace.mean(r["syncs"] for r in frame_trace.replayed())
