"""The (splat, tile) pairs the hybrid frame's deep shadow maps bin per
frame: the mean of its ``RenderOutput.shadow_pairs`` (every map face's
live pairs, summed) over the traced frames."""


def read(t):
    pairs = t.counters.get("shadow_pairs")
    if t.kind != "view" or not pairs:
        return None
    return sum(pairs) / len(pairs)
