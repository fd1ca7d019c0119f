"""Device milliseconds per hybrid frame launched inside the program's
``shade`` span (kinds/hybrid.py adds it to the summary:
splatbench/spans.py)."""


def read(t):
    if t.kind != "view" or "shade" not in t.span_s:
        return None
    return 1e3 * t.span_s["shade"] / t.calls
