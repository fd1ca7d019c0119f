"""Device milliseconds per frame launched inside the program's ``project`` span."""


def read(t):
    if t.kind != "view" or "project" not in t.span_s:
        return None
    return 1e3 * t.span_s["project"] / t.calls
