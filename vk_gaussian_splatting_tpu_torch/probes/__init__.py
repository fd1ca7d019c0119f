"""The design probes P1-P3 on the card: counterparts of the JAX package's
Pallas probes in ``scripts/``, one module per script, each runnable as
``python -m vk_gaussian_splatting_tpu_torch.probes.<name>`` with the
script's arguments:

- ``bench_roll`` (P1, scripts/bench_roll.py): a full bitonic sort of
  (R, C) tiles in shared memory, kernel csrc/bench_roll.cu;
- ``bench_sort_stage`` (P3, scripts/bench_sort_stage.py): bitonic stages
  over (ROWS, 1024) tiles in three mask and layout styles, kernel
  csrc/bench_sort_stage.cu;
- ``bench_radix_ab`` (P2, scripts/bench_radix_ab.py): pipelined bulk
  copies of (16, 128) f32 blocks into shared memory (csrc/bench_radix_ab.cu),
  the port's own bucket sort stage timed at 1 M - 16 M rows, and the run
  statistics of a counting sort's pass B.

P1 and P3 share one stage (csrc/bitonic.cuh). The probes feed no output of
the renderer; they measure design questions for the card. Each kernel's
wrapper launches it on CUDA tensors and runs its plain PyTorch twin on CPU
tensors, and counts its launches. The entry points run on the card unless
given ``device="cpu"``, and print the card's name and power limit beside
every number.
"""
