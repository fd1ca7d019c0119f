"""The whole frame's share of the card's peak: the bound of the frame's
needed work (counts.frame) over the mean wall time of a traced frame."""

from splatbench import counts


def read(t):
    if t.kind != "view" or "frame" not in t.work:
        return None
    return counts.share_percent(t.work["frame"], t.window_s / t.calls)
