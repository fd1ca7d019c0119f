"""The pair blender's backward K2's share of its roofline per step: the
bound of the blend's needed backward work (counts.blend_bwd) over the
device time of ``rasterize_bwd_kernel``."""

from splatbench import counts


def read(t):
    secs = sum(s for name, s in t.kernel_s.items() if "rasterize_bwd" in name)
    if t.kind != "train" or "blend_bwd" not in t.work or not secs:
        return None
    return counts.share_percent(t.work["blend_bwd"], secs / t.calls)
