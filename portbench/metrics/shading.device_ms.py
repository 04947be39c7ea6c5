"""Device ms a frame of the shading passes: the program's spans
``frame.shade``, ``frame.peel_shade``, ``frame.mask`` and
``frame.tss_spec`` on eager frames at poses of the window."""

SPANS = ("frame.shade", "frame.peel_shade", "frame.mask", "frame.tss_spec")


def read(readings):
    v = sum(readings["trace"]["spans"][s] for s in SPANS)
    return v or None
