"""Greedy best-first association on the lane layout.

``min(D, T)`` rounds of a masked argmax over the flat ``d*T + t`` index of
each lane's ``[D, T]`` IoU matrix; a tie goes to the first index, as in
the reference, so both packages pick the same pairs.
"""
from __future__ import annotations

import torch


def greedy_assign_lane(iou: torch.Tensor, det_mask: torch.Tensor,
                       trk_mask: torch.Tensor, iou_threshold: float = 0.3):
    """``iou [D, T, ...]``, ``det_mask [D, ...]``, ``trk_mask [T, ...]``
    (bool or 0/1 float) -> ``(trk_to_det [T, ...] int32, matched_det
    [D, ...] bool)``.

    Pairs below the threshold, or with a masked row or column, score the
    sentinel ``-1.0``; a round whose best score is not above ``0.0``
    matches nothing.  A matched pair retires its row and column.
    """
    d, t = iou.shape[0], iou.shape[1]
    lanes = iou.shape[2:]
    dev = iou.device
    valid = ((det_mask[:, None] > 0) & (trk_mask[None, :] > 0)
             & (iou >= iou_threshold))
    score = torch.where(valid, iou, -1.0)
    trk_to_det = torch.full((t,) + lanes, -1, dtype=torch.int32, device=dev)
    matched_det = torch.zeros((d,) + lanes, dtype=torch.bool, device=dev)
    ones = (1,) * len(lanes)
    iota = torch.arange(max(d, t), dtype=torch.int32, device=dev)
    di_iota = iota[:d].reshape((d,) + ones)
    ti_iota = iota[:t].reshape((t,) + ones)

    for _ in range(min(d, t)):
        flat = score.reshape((d * t,) + lanes)
        idx = torch.argmax(flat, dim=0).to(torch.int32)     # first max
        ok = torch.amax(flat, dim=0) > 0.0
        di, ti = idx // t, idx % t
        hit_trk = (ti_iota == ti[None]) & ok[None]           # [T, ...]
        hit_det = (di_iota == di[None]) & ok[None]           # [D, ...]
        trk_to_det = torch.where(hit_trk, di[None], trk_to_det)
        matched_det = matched_det | hit_det
        score = torch.where(hit_det[:, None] | hit_trk[None, :], -1.0, score)
    return trk_to_det, matched_det
