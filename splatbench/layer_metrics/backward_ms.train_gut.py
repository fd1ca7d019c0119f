"""``backward_ms.train``'s reading in the 3DGUT training cells, which report
``train_steps_per_s.gut`` (layer_metrics/backward_ms.train.py)."""

from splatbench import spec

read = spec.load_reader("backward_ms.train")
