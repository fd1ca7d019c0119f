"""The pair blender K1's share of its roofline per frame: the bound of the
blend's needed work (counts.blend_fwd) over the device time of K1's two
kernels (``warp_mask_kernel``, ``rasterize_fwd_kernel``)."""

from splatbench import counts

NAMES = ("rasterize_fwd", "warp_mask")


def read(t):
    secs = sum(s for name, s in t.kernel_s.items() if any(n in name for n in NAMES))
    if t.kind != "view" or "blend_fwd" not in t.work or not secs:
        return None
    return counts.share_percent(t.work["blend_fwd"], secs / t.calls)
