"""The (splat, tile) pairs the program bins per frame: the mean of its
``RenderOutput.num_pairs`` over the traced frames."""


def read(t):
    pairs = t.counters.get("num_pairs")
    if t.kind != "view" or not pairs:
        return None
    return sum(pairs) / len(pairs)
