"""splatbench: the benchmark of ``vk_gaussian_splatting_tpu_torch``.

One command runs one cell (a configuration under a traffic mix) once:

    python3 -m splatbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cells, metrics and bounds are listed in ``BENCHMARK.json`` at the root
of the checkout. Everything that belongs to one configuration, traffic mix,
kind of traffic, reference or per-layer metric is a file of its own, found
by name:

- ``configs/<config>.json``: the deployment (scene size, resolution,
  training settings) with its source, ``assumed`` and ``reduced``;
- ``traffic/<mix>.json``: the parameters of a traffic mix with the limits
  of its checks; it names its runner, reference and work counts and sets
  the program's render configuration field by field (workloads.py);
- ``kinds/<kind>.py``: the runner of a kind of traffic (``view``,
  ``train``), whose ``run`` makes the inputs from the seed and drives the
  program through set-up, the window and the check;
- ``reference/<name>.py``: a plain float32 reference frame (``gs3d``,
  ``gut3d``) with its work counts ``work/<name>.py``;
- ``layer_metrics/<metric>.py``: a ``read(trace)`` function that takes one
  per-layer metric from the traced window (``trace.TraceSummary``), or
  returns None where it finds nothing to read.

The yardstick lives here and nowhere in the program it judges: the scene
and camera generators (``scene.py``, ``cameras.py``), the plain float32
references (``reference/``), the work counts and peaks of the rooflines
(``work/``, ``counts.py``), the reduction of the profiler trace
(``trace.py``) and the comparison that decides ``correct`` (``checks.py``). From the program the
benchmark takes the entry points under test (``render``, ``train_step``),
their profiler spans, their ``num_pairs`` and ``overflow`` outputs and the
names of their kernels. It never imports JAX or the JAX package.

``python3 -m splatbench.calibrate`` reads the control and the faults at a
cell's size on the card; ``python3 -m pytest splatbench/tests -n 0`` runs
the benchmark's own CPU tests.
"""
