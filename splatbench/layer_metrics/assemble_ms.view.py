"""Device milliseconds per frame launched inside the program's ``assemble`` span."""


def read(t):
    if t.kind != "view" or "assemble" not in t.span_s:
        return None
    return 1e3 * t.span_s["assemble"] / t.calls
