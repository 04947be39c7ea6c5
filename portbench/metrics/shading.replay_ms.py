"""Device ms a replayed frame of the shading passes: the clock stamps of
``frame.shade``, ``frame.peel_shade``, ``frame.mask`` and
``frame.tss_spec`` inside the replayed frame program, the mean over the
profiled window's frames (the gaps between the graph's kernels
included)."""

from portbench import frame_trace

REGIONS = ("frame.shade", "frame.peel_shade", "frame.mask", "frame.tss_spec")


def read(readings):
    return frame_trace.device_ms(REGIONS)
