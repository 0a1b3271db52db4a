"""Dispatch of the fused frame step: the CUDA kernel or its plain version.

All operands are in the persistent lane layout (``x [7, T, S]``,
``p [49, T, S]``, ``det [D, 4, S]``, masks ``[*, S]`` 0/1 float).
"""
from __future__ import annotations

import torch

from . import frame, ref
from ..core.association import associate_lane

__all__ = ["frame_step"]


def frame_step(x, p, det, det_mask, alive, stream_active=None, *,
               iou_threshold: float = 0.3, mode: str = "auto",
               assoc: str = "greedy"):
    """One SORT frame for every stream (predict -> IoU -> assign -> update).

    ``stream_active [1, S]`` 0/1 float (optional) marks the lanes that carry
    a frame; the others are exact no-ops.

    ``assoc``: ``"greedy"`` matches inside the kernel; ``"hungarian"``
    solves the lane-batched assignment first (:func:`_hungarian_stage`) and
    hands the kernel the gated ``trk_to_det``.

    ``mode``: ``"auto"`` launches the kernel for CUDA tensors and runs the
    plain :func:`ref.frame_lane` for CPU ones; ``"ref"`` forces the plain
    version; ``"kernel"`` forces the kernel and raises on CPU tensors.

    Returns ``(x, p, trk_to_det [T, S] int32, matched_det [D, S] bool)``.
    """
    if assoc not in ("greedy", "hungarian"):
        raise ValueError(f"unknown assoc {assoc!r}")
    if mode == "auto":
        mode = "kernel" if x.is_cuda else "ref"
    if mode == "ref":
        return ref.frame_lane(x, p, det, det_mask, alive, iou_threshold,
                              active=stream_active, assoc=assoc)
    if mode != "kernel":
        raise ValueError(f"unknown mode {mode!r}")
    if not x.is_cuda:
        raise RuntimeError("mode='kernel' needs CUDA tensors; the CPU runs "
                           "the plain version (mode='ref' or 'auto')")
    t2d_pre = (None if assoc == "greedy"
               else _hungarian_stage(x, det, det_mask, alive, stream_active,
                                     iou_threshold))
    x, p, t2d, md = frame.fused_frame(
        x.contiguous(), p.contiguous(), det.contiguous(),
        det_mask.contiguous(), alive.contiguous(),
        None if stream_active is None else stream_active.contiguous(),
        t2d_pre, iou_threshold=iou_threshold)
    return x, p, t2d, md > 0


def _hungarian_stage(x, det, det_mask, alive, stream_active,
                     iou_threshold: float) -> torch.Tensor:
    """The lane-batched Hungarian stage that feeds the kernel.

    Recomputes the predicted means (7 rows of adds; the covariance is left
    to the kernel), builds the ``[D, T, S]`` IoU and solves and gates one
    tiny assignment per lane.  Returns ``trk_to_det [T, S] int32``.
    """
    dm = det_mask > 0
    if stream_active is not None:
        dm = dm & (stream_active > 0)
    x_pred = ref.predict_mean_lane(x)                             # [7, T, S]
    iou = ref.iou_lane(det, ref.z_to_xyxy_lane(x_pred[:4]))       # [D, T, S]
    t2d, _ = associate_lane(iou, dm, alive > 0, iou_threshold)
    return t2d.contiguous()
