"""Device ms a replayed frame of triangle setup and binning: the clock
stamps of ``frame.setup`` and ``frame.bin_pack`` inside the replayed
frame program, the mean over the profiled window's frames."""

from portbench import frame_trace

REGIONS = ("frame.setup", "frame.bin_pack")


def read(readings):
    return frame_trace.device_ms(REGIONS)
