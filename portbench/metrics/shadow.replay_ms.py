"""Device ms a replayed shadow-dirty frame of the shadow pass and the
texture-space bakes: the clock stamps of ``frame.shadow`` (inside the
shadow program) and ``frame.tss_bake`` (around the bake programs' replays),
the mean over the profiled window's shadow-dirty frames."""

from portbench import frame_trace

REGIONS = ("frame.shadow", "frame.tss_bake")


def read(readings):
    return frame_trace.device_ms(REGIONS, dirty_only=True)
