"""Device milliseconds per training step launched inside the forward
spans: prepare, the frame's project, bin, rays (3DGUT), blend and assemble,
and loss."""

SPANS = ("prepare", "project", "bin", "rays", "blend", "assemble", "loss")


def read(t):
    if t.kind != "train" or not any(s in t.span_s for s in SPANS):
        return None
    return 1e3 * sum(t.span_s.get(s, 0.0) for s in SPANS) / t.calls
