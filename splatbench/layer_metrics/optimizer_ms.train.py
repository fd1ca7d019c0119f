"""Device milliseconds per training step launched inside the ``optimizer`` span."""


def read(t):
    if t.kind != "train" or "optimizer" not in t.span_s:
        return None
    return 1e3 * t.span_s["optimizer"] / t.calls
