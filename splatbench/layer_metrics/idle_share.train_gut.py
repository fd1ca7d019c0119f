"""``idle_share.train``'s reading in the 3DGUT training cells, which report
``train_steps_per_s.gut`` (layer_metrics/idle_share.train.py)."""

from splatbench import spec

read = spec.load_reader("idle_share.train")
