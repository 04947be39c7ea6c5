"""Host ms of one ``FrameRenderer.render()`` call, the mean over every
frame of the window (the benchmark's host clock around each call the
render loop makes): the render loop and entry point's dispatch cost."""


def read(readings):
    ms = readings["render_ms"]
    return sum(ms) / len(ms) if ms else None
