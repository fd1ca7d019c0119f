"""The whole training step's share of the card's peak: the bound of the
step's needed work (counts.train_step) over the mean wall time of a traced step."""

from splatbench import counts


def read(t):
    if t.kind != "train" or "step" not in t.work:
        return None
    return counts.share_percent(t.work["step"], t.window_s / t.calls)
