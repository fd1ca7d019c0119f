"""Device milliseconds per hybrid frame launched inside the program's
``normals`` span (kinds/hybrid.py adds it to the summary:
splatbench/spans.py)."""


def read(t):
    if t.kind != "view" or "normals" not in t.span_s:
        return None
    return 1e3 * t.span_s["normals"] / t.calls
