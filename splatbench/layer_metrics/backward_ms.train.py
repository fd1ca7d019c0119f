"""Device milliseconds per training step launched inside the ``backward`` span."""


def read(t):
    if t.kind != "train" or "backward" not in t.span_s:
        return None
    return 1e3 * t.span_s["backward"] / t.calls
