"""``idle_share.view``'s reading in the hybrid cells (layer_metrics/idle_share.view.py)."""

from splatbench import spec

read = spec.load_reader("idle_share.view")
