"""``forward_ms.train``'s reading in the 3DGUT training cells, which report
``train_steps_per_s.gut`` (layer_metrics/forward_ms.train.py)."""

from splatbench import spec

read = spec.load_reader("forward_ms.train")
