"""Device ms a shadow-dirty frame of the shadow pass and the
texture-space bakes: the program's spans ``frame.shadow`` and
``frame.tss_bake`` on eager shadow-dirty frames at poses of the window.
Frames that render no shadow pass read nothing."""

SPANS = ("frame.shadow", "frame.tss_bake")


def read(readings):
    v = sum(readings["trace"]["spans"][s] for s in SPANS)
    return v or None
