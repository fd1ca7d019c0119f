"""``blend_bwd_roofline.train``'s reading in the 3DGUT training cells, which report
``train_steps_per_s.gut`` (layer_metrics/blend_bwd_roofline.train.py)."""

from splatbench import spec

read = spec.load_reader("blend_bwd_roofline.train")
