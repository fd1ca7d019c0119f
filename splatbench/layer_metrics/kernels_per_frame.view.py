"""Kernels the device ran per frame in the traced window."""


def read(t):
    if t.kind != "view" or not t.kernels:
        return None
    return t.kernels / t.calls
