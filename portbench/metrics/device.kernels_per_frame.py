"""Kernel records of the profiled window of replayed frames, per frame:
how many launches the compiled frame replays."""


def read(readings):
    t = readings["trace"]
    return t["kernels"] / t["frames"] if t["kernels"] else None
