"""Share (%) of the profiled window of replayed frames in which no
operation ran on the card: 1 - (union of the device operations'
intervals) / window."""


def read(readings):
    t = readings["trace"]
    if not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
