"""Detection <-> tracker association (paper §II-B, step "Assign").

The IoU cost between predicted boxes and the frame's detections is solved
with the batched Hungarian solver and gated by the IoU threshold — the
SORT recipe, batched over streams with static shapes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import hungarian


class Association(NamedTuple):
    """All masks are aligned to the padded det/tracker slot axes.

    ``det_to_trk [..., D] int32``: matched tracker slot per detection (or -1).
    ``trk_to_det [..., T] int32``: matched detection per tracker slot (or -1).
    ``matched_det [..., D] bool``  / ``matched_trk [..., T] bool``.
    ``unmatched_det [..., D] bool``: valid detections that should seed births.
    ``unmatched_trk [..., T] bool``: alive trackers that missed this frame.
    """

    det_to_trk: torch.Tensor
    trk_to_det: torch.Tensor
    matched_det: torch.Tensor
    matched_trk: torch.Tensor
    unmatched_det: torch.Tensor
    unmatched_trk: torch.Tensor
    iou: torch.Tensor  # [..., D, T]


def _all_unmatched(iou: torch.Tensor, det_mask: torch.Tensor,
                   trk_mask: torch.Tensor) -> Association:
    """Degenerate frame (``D == 0`` or ``T == 0``): nothing can match."""
    d, t = iou.shape[-2], iou.shape[-1]
    batch = iou.shape[:-2]
    dev = iou.device
    return Association(
        det_to_trk=torch.full(batch + (d,), -1, dtype=torch.int32, device=dev),
        trk_to_det=torch.full(batch + (t,), -1, dtype=torch.int32, device=dev),
        matched_det=torch.zeros(batch + (d,), dtype=torch.bool, device=dev),
        matched_trk=torch.zeros(batch + (t,), dtype=torch.bool, device=dev),
        unmatched_det=det_mask.expand(batch + (d,)),
        unmatched_trk=trk_mask.expand(batch + (t,)),
        iou=iou)


def associate_from_iou(iou: torch.Tensor, det_mask: torch.Tensor,
                       trk_mask: torch.Tensor,
                       iou_threshold: float = 0.3) -> Association:
    """Solve + gate + invert, from an IoU matrix ``[..., D, T]`` (batch
    leading) and bool masks ``[..., D]`` / ``[..., T]``."""
    d, t = iou.shape[-2], iou.shape[-1]
    if d == 0 or t == 0:
        return _all_unmatched(iou, det_mask, trk_mask)
    n = max(d, t)
    col4row = hungarian.solve_masked(-iou, det_mask, trk_mask, n)  # [..., n]
    return _gate_and_invert(iou, det_mask, trk_mask, col4row, iou_threshold)


def _gate_and_invert(iou, det_mask, trk_mask, col4row,
                     iou_threshold) -> Association:
    """Keep each detection's solver column only if it is in range, a valid
    tracker and above the IoU threshold, then scatter the matching into
    tracker-major form."""
    d, t = iou.shape[-2], iou.shape[-1]
    batch = iou.shape[:-2]
    dev = iou.device
    assigned_col = col4row[..., :d].long()                 # [..., D]
    in_range = assigned_col < t
    safe_col = torch.where(in_range, assigned_col, 0)
    pair_iou = torch.gather(iou, -1, safe_col[..., None])[..., 0]
    pair_trk_valid = torch.gather(trk_mask.expand(batch + (t,)), -1, safe_col)
    good = (det_mask & in_range & pair_trk_valid
            & (pair_iou >= iou_threshold))

    det_to_trk = torch.where(good, safe_col, -1).to(torch.int32)
    # invert: each good detection's index goes to its tracker slot; the
    # rest go to an overflow slot that is sliced off (a matching, so no
    # real slot collides)
    overflow = torch.full(batch + (t + 1,), -1, dtype=torch.int32, device=dev)
    scatter_idx = torch.where(good, safe_col, t)
    src = torch.arange(d, dtype=torch.int32, device=dev).expand(batch + (d,))
    trk_to_det = overflow.scatter(-1, scatter_idx, src)[..., :t]

    matched_trk = trk_to_det >= 0
    return Association(det_to_trk, trk_to_det, good, matched_trk,
                       det_mask & ~good, trk_mask & ~matched_trk, iou)


def associate_lane(iou: torch.Tensor, det_mask: torch.Tensor,
                   trk_mask: torch.Tensor, iou_threshold: float = 0.3):
    """Hungarian association on the lane layout.

    ``iou [D, T, *lanes]``, ``det_mask [D, *lanes]``, ``trk_mask
    [T, *lanes]`` (bool or 0/1 float) -> ``(trk_to_det [T, *lanes] int32,
    matched_det [D, *lanes] bool)``, through the same solve + gate + invert
    core as :func:`associate_from_iou`.
    """
    d, t = iou.shape[0], iou.shape[1]
    lanes = iou.shape[2:]
    if d == 0 or t == 0:
        return (torch.full((t,) + lanes, -1, dtype=torch.int32,
                           device=iou.device),
                torch.zeros((d,) + lanes, dtype=torch.bool,
                            device=iou.device))
    iou_b = torch.movedim(iou.reshape(d, t, -1), -1, 0)            # [L, D, T]
    dm_b = torch.movedim((det_mask > 0).reshape(d, -1), -1, 0)     # [L, D]
    tm_b = torch.movedim((trk_mask > 0).reshape(t, -1), -1, 0)     # [L, T]
    a = associate_from_iou(iou_b, dm_b, tm_b, iou_threshold)
    trk_to_det = torch.movedim(a.trk_to_det, 0, -1).reshape((t,) + lanes)
    matched_det = torch.movedim(a.matched_det, 0, -1).reshape((d,) + lanes)
    return trk_to_det, matched_det
