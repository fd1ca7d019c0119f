"""The plain float32 references of the benchmark's cells.

``gs3d``: the 3DGS raster frame (EWA projection with SH radiance, per-tile
depth order, front-to-back blend with per-pixel termination), written from
the published method and the reference viewer's shaders, in blocks so that
it fits beside a 6.13M-splat scene. ``gut3d``: the 3DGUT raster frame (the
unscented-transform projection, the same order and blend with each pixel's
ray against the 3D Gaussian). ``train``: the loss, gradients by autograd
through either frame and Adam. None imports anything of the program under
test; all run on whatever device their inputs are on. Callers turn TF32
off (``splatbench.workloads.plain_float32``).
"""
