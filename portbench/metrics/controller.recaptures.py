"""Frame-program captures during the window (the difference of the
renderer's ``program_counts["frame_captures"]``): each is a budget
re-tune of the controller paid inside the measured window."""


def read(readings):
    return readings["window"]["recaptures"]
