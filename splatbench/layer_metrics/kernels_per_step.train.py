"""Kernels the device ran per training step in the traced window."""


def read(t):
    if t.kind != "train" or not t.kernels:
        return None
    return t.kernels / t.calls
