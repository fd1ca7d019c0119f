"""The numbers that decide ``correct``, each against its limit.

A view cell compares each checked frame of the timed path with the
reference's frame of the same splats and camera: the image's root mean
square gap, the share of pixels whose transmittance differs by more than
``T_TOLERANCE``, and the share whose picked splat or depth differs. A root
mean square and shares, not the widest gap: a (pixel, splat) whose
exponent or alpha rounds to the other side of the blend's cutoffs moves
one pixel by up to 0.02 in either of two sound programs. The program
stops a pixel at the end of its 128-pair chunk, the reference at the
splat, so where T fell under 1e-4 the two part by up to 1e-4: the
transmittance's tolerance is twice that. A training cell compares the first steps' losses, the first
gradient's norm and the parameters' change after the checked steps, each
by the worst field (leaf).
"""

from __future__ import annotations

import statistics

import torch

LEAF_FLOOR = 1e-3   # leaves whose reference gradient is under this share of the median leaf's
T_TOLERANCE = 2e-4  # a pixel's transmittance differs beyond the termination's 1e-4


def frame_numbers(image, transmittance, depth, splat_id, ref) -> dict:
    """The gaps of one program frame from the reference's ``Frame``."""
    img_rmse = torch.sqrt(torch.mean((image.float() - ref.image) ** 2))
    t_off = torch.mean((torch.abs(transmittance.float() - ref.transmittance)
                        > T_TOLERANCE).float())
    ids = splat_id.to(torch.int64)
    depth_off = torch.abs(depth - ref.depth) > 1e-5 * torch.clamp(torch.abs(ref.depth), min=1.0)
    pick = torch.mean(((ids != ref.splat_id) | depth_off).float())
    return dict(image_rmse=float(img_rmse), transmittance_off_share=float(t_off),
                pick_mismatch_share=float(pick))


def worst(rows: list) -> dict:
    return {k: max(r[k] for r in rows) for k in rows[0]}


def _leaf_gap(prog: dict, ref: dict, leaves) -> float:
    med = statistics.median(ref[f] for f in leaves)
    return max(abs(prog[f] - ref[f]) / max(ref[f], med) for f in leaves)


def train_numbers(prog: dict, ref: dict) -> tuple[dict, list]:
    """(numbers, the leaves left out of the change) of the program's first
    steps against the reference's: ``losses`` per step, ``grad1`` and
    ``change`` norms per field."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    fields = list(ref["grad1"])
    med = statistics.median(ref["grad1"][f] for f in fields)
    moved = [f for f in fields if ref["grad1"][f] >= LEAF_FLOOR * med]
    return (dict(loss_gap=loss_gap, grad1_gap=_leaf_gap(prog["grad1"], ref["grad1"], fields),
                 change_gap=_leaf_gap(prog["change"], ref["change"], moved)),
            [f for f in fields if f not in moved])


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}})."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return all(v <= limits[k] for k, v in numbers.items()), checks
