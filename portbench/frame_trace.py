"""The program's own record of the profiled window's frames: one record
per ``render()`` call made under ``torch.profiler``
(``renderengine_tpu_torch.utils.profiling.frame_trace``), with the
device ms of each pass from the clock stamps inside the replayed frame
program, the host ms of the renderer's ``host.*`` spans and the host
syncs of the call. A program without that record reads as no frames, so
the metrics that read it fall silent."""

from __future__ import annotations


def replayed() -> list[dict]:
    """The records of replayed frames, [] without the record."""
    try:
        from renderengine_tpu_torch.utils.profiling import frame_trace
    except ImportError:
        return []
    return [r for r in frame_trace() if r.get("replayed")]


def mean(values) -> float | None:
    values = list(values)
    return sum(values) / len(values) if values else None


def device_ms(regions, dirty_only: bool = False) -> float | None:
    """Mean over the replayed frames whose stamps were read (only the
    shadow-dirty ones with ``dirty_only``) of the summed device ms of
    ``regions``."""
    return mean(sum(r["device_ms"][n] for n in regions)
                for r in replayed()
                if r["device_ms"] is not None
                and (r["dirty"] or not dirty_only))
