"""Device milliseconds per frame launched inside the program's ``bin`` span."""


def read(t):
    if t.kind != "view" or "bin" not in t.span_s:
        return None
    return 1e3 * t.span_s["bin"] / t.calls
