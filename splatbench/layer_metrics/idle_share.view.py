"""The share of the traced window of frames in which no device operation ran."""


def read(t):
    if t.kind != "view" or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
