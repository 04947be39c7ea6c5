"""Device ms a replayed shadow-dirty frame of a point light's cube
shadow: the clock stamps of ``frame.shadow_cube`` (the six face setups
and K1 launches inside the shadow program) and ``frame.vis_cube`` (the
cube lookup inside the visibility bake program), the mean over the
profiled window's shadow-dirty frames. A program that stamps neither
region reads nothing."""

from portbench import frame_trace

REGIONS = ("frame.shadow_cube", "frame.vis_cube")


def read(readings):
    recs = [r for r in frame_trace.replayed()
            if r["dirty"] and r["device_ms"] is not None]
    if not recs or any(n not in recs[0]["device_ms"] for n in REGIONS):
        return None
    return frame_trace.device_ms(REGIONS, dirty_only=True) or None
