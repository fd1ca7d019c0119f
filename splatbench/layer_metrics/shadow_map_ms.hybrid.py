"""Device milliseconds per hybrid frame launched inside the program's
``shadow_map`` spans, one per light with its maps (kinds/hybrid.py adds
them to the summary: splatbench/spans.py)."""


def read(t):
    if t.kind != "view" or "shadow_map" not in t.span_s:
        return None
    return 1e3 * t.span_s["shadow_map"] / t.calls
