"""``kernels_per_step.train``'s reading in the 3DGUT training cells, which report
``train_steps_per_s.gut`` (layer_metrics/kernels_per_step.train.py)."""

from splatbench import spec

read = spec.load_reader("kernels_per_step.train")
