"""``mfu.view``'s reading in the hybrid cells: the bound of the whole
hybrid frame's needed work (work/hybrid.frame: every pass) over the mean
wall time of a traced frame (layer_metrics/mfu.view.py)."""

from splatbench import spec

read = spec.load_reader("mfu.view")
