"""Device ms a frame of triangle setup and binning: the program's spans
``frame.setup`` and ``frame.bin_pack`` on eager frames at poses of the
window."""

SPANS = ("frame.setup", "frame.bin_pack")


def read(readings):
    v = sum(readings["trace"]["spans"][s] for s in SPANS)
    return v or None
