"""Host ms a shadow-dirty frame of the shadow-map refit
(``fitting.shadow_transforms_for_scene``, the program's span
``host.shadow_fit``), the mean over the profiled window's replayed
shadow-dirty frames."""

from portbench import frame_trace


def read(readings):
    return frame_trace.mean(r["host_ms"].get("host.shadow_fit", 0.0)
                            for r in frame_trace.replayed() if r["dirty"])
