"""Device milliseconds per frame launched inside the program's ``blend`` span."""


def read(t):
    if t.kind != "view" or "blend" not in t.span_s:
        return None
    return 1e3 * t.span_s["blend"] / t.calls
