"""The work counts of the rooflines and mfu, one module per response model,
found by the ``work`` of a traffic file: ``work/<name>.py`` with
``blend_fwd``, ``blend_bwd``, ``frame`` and ``train_step``."""
