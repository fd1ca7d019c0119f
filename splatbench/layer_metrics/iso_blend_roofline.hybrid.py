"""K1i's share of its roofline per hybrid frame: the bound of the maps'
needed blend work (work/hybrid.shadow_blend) over the device time of K1i's
two kernels in the frame's ``shadow_map`` spans: its blend, told from K1's
by the ISO template argument of ``rasterize_fwd_kernel`` (the last, true),
and its cull, ``warp_mask_kernel``, which has no such argument and is
K1i's where a map launches it."""

import re

from splatbench import counts

ISO_BLEND = re.compile(r"rasterize_fwd_kernel<[^<>]*,\s*true>")


def read(t):
    inside = getattr(t, "span_kernel_s", {}).get("shadow_map", {})
    secs = sum(s for name, s in inside.items()
               if ISO_BLEND.search(name) or "warp_mask_kernel" in name)
    if t.kind != "view" or "shadow_blend" not in t.work or not secs:
        return None
    return counts.share_percent(t.work["shadow_blend"], secs / t.calls)
