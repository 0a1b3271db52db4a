"""Plain PyTorch versions of the lane-layout SORT kernels.

Layout: the tracker batch lives on the trailing (lane) axes.  State is
``x [7, ...]``, covariance ``p [49, ...]`` (row-major flattened 7x7),
observation ``z [4, ...]``, mask ``[1, ...]`` (0/1 in the state dtype).

Every function repeats the operation order of the JAX package's lane
oracles element for element — sums start from ``0``, off-diagonal noise
adds ``0.0``, the ``_EPS`` clamps sit where they sat — so on the CPU they
agree with the reference run eagerly bit for bit, and on the card with
the CUDA kernel, which is compiled without FMA contraction.  Where the
reference unrolls a loop over matrix entries, these versions broadcast
the same per-element arithmetic over a whole block at once.

They are the CPU path of :func:`repro_torch.kernels.frame.fused_frame`
and the yardstick it is held against on the card.
"""
from __future__ import annotations

import torch

from ..core import association, greedy
from ..core.kalman import Q_DIAG, R_DIAG

_EPS = 1e-9


def _mat(p: torch.Tensor) -> torch.Tensor:
    """``[49, ...]`` -> the free ``[7, 7, ...]`` view."""
    return p.reshape((7, 7) + p.shape[1:])


def _add_diag(m: torch.Tensor, diag) -> torch.Tensor:
    """``m + D`` for a constant diagonal ``D``: off-diagonal entries add
    ``0.0`` (which turns ``-0.0`` into ``+0.0``, as the reference does) and
    the diagonal adds its value.  For a nonzero value ``(v + 0.0) + q`` is
    ``v + q`` exactly, so no constant tensor has to be built on the device.
    """
    out = m + 0.0
    for i, q in enumerate(diag):
        out[i, i] += q
    return out


def predict_mean_lane(x: torch.Tensor) -> torch.Tensor:
    """The mean half of :func:`predict_lane` — ``x [7, ...]`` only."""
    ds = torch.where(x[2] + x[6] <= 0.0, 0.0, x[6])
    return torch.stack([x[0] + x[4], x[1] + x[5], x[2] + ds, x[3],
                        x[4], x[5], ds], dim=0)


def predict_lane(x: torch.Tensor, p: torch.Tensor):
    """Constant-velocity predict on lane layout. ``x [7,...]``, ``p [49,...]``.

    ``(F P F^T)[i, j] = p[i,j] (+ p[i+4,j] if i<3) (+ p[i,j+4] if j<3)
    (+ p[i+4,j+4] if i,j<3)``, added in that order, then ``+ Q``.
    """
    x_new = predict_mean_lane(x)
    pm = _mat(p)
    fp = pm.clone()
    fp[:3] = fp[:3] + pm[4:]
    fp[:, :3] = fp[:, :3] + pm[:, 4:]
    fp[:3, :3] = fp[:3, :3] + pm[4:, 4:]
    return x_new, _add_diag(fp, Q_DIAG).reshape(p.shape)


def _inv2(m00, m01, m10, m11):
    det = m00 * m11 - m01 * m10
    inv = 1.0 / det
    return m11 * inv, -m01 * inv, -m10 * inv, m00 * inv


def _inv4(s):
    """Blockwise inverse of SPD 4x4 given as ``[[(...) x4] x4]``."""
    a00, a01, a10, a11 = s[0][0], s[0][1], s[1][0], s[1][1]
    b00, b01, b10, b11 = s[0][2], s[0][3], s[1][2], s[1][3]
    c00, c01, c10, c11 = s[2][0], s[2][1], s[3][0], s[3][1]
    d00, d01, d10, d11 = s[2][2], s[2][3], s[3][2], s[3][3]
    ai00, ai01, ai10, ai11 = _inv2(a00, a01, a10, a11)
    # C A^-1 (2x2)
    ca00 = c00 * ai00 + c01 * ai10
    ca01 = c00 * ai01 + c01 * ai11
    ca10 = c10 * ai00 + c11 * ai10
    ca11 = c10 * ai01 + c11 * ai11
    # A^-1 B (2x2)
    ab00 = ai00 * b00 + ai01 * b10
    ab01 = ai00 * b01 + ai01 * b11
    ab10 = ai10 * b00 + ai11 * b10
    ab11 = ai10 * b01 + ai11 * b11
    # Schur = D - C A^-1 B
    s00 = d00 - (ca00 * b00 + ca01 * b10)
    s01 = d01 - (ca00 * b01 + ca01 * b11)
    s10 = d10 - (ca10 * b00 + ca11 * b10)
    s11 = d11 - (ca10 * b01 + ca11 * b11)
    si00, si01, si10, si11 = _inv2(s00, s01, s10, s11)
    # TL = Ai + AB @ Si @ CA ; TR = -AB @ Si ; BL = -Si @ CA ; BR = Si
    absi00 = ab00 * si00 + ab01 * si10
    absi01 = ab00 * si01 + ab01 * si11
    absi10 = ab10 * si00 + ab11 * si10
    absi11 = ab10 * si01 + ab11 * si11
    tl00 = ai00 + absi00 * ca00 + absi01 * ca10
    tl01 = ai01 + absi00 * ca01 + absi01 * ca11
    tl10 = ai10 + absi10 * ca00 + absi11 * ca10
    tl11 = ai11 + absi10 * ca01 + absi11 * ca11
    tr00, tr01 = -absi00, -absi01
    tr10, tr11 = -absi10, -absi11
    bl00 = -(si00 * ca00 + si01 * ca10)
    bl01 = -(si00 * ca01 + si01 * ca11)
    bl10 = -(si10 * ca00 + si11 * ca10)
    bl11 = -(si10 * ca01 + si11 * ca11)
    return [[tl00, tl01, tr00, tr01],
            [tl10, tl11, tr10, tr11],
            [bl00, bl01, si00, si01],
            [bl10, bl11, si10, si11]]


def _dot4(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum(a[:, k] * b[k] for k in range(4))``: contracts axis 1 of ``a``
    with axis 0 of ``b`` (the rest broadcasts), accumulated from ``0`` in
    ``k`` order like the reference's Python ``sum``."""
    acc = 0
    for k in range(4):
        acc = acc + a[:, k] * b[k]
    return acc


def update_lane(x: torch.Tensor, p: torch.Tensor, z: torch.Tensor,
                mask: torch.Tensor):
    """Masked measurement update on lane layout.

    ``x [7,...]``, ``p [49,...]``, ``z [4,...]``, ``mask [1,...]`` (0/1).
    """
    pm = _mat(p)
    y = z - x[:4]
    s = _add_diag(pm[:4, :4], R_DIAG)                        # P[:4,:4] + R
    sinv = torch.stack([torch.stack(row) for row in _inv4(s)])  # [4,4,...]
    # K = P[:, 0:4] @ Sinv  -> [7, 4, ...]
    k = _dot4(pm[:, :4, None], sinv)
    x_new = x + _dot4(k, y)
    # P_new = (I - K H) P ;  (K H)[i, j] = K[i, j] for j < 4 else 0
    p_new = (pm - _dot4(k[:, :, None], pm[:4])).reshape(p.shape)
    m = mask[0]
    return (m * x_new + (1.0 - m) * x), (m * p_new + (1.0 - m) * p)


def z_to_xyxy_lane(x: torch.Tensor) -> torch.Tensor:
    """``x [>=4, ...]`` -> boxes, stacked on a new axis 1 when the input
    is ``[7, T, B]`` (-> ``[T, 4, B]``), else on axis 0."""
    u, v = x[0], x[1]
    s = torch.clamp_min(x[2], 0.0)
    r = torch.clamp_min(x[3], _EPS)
    # PyTorch's vectorised float32 sqrt on the CPU may miss correct rounding
    # by an ulp; a float64 root rounded to float32 is the correctly rounded
    # float32 root, which is what XLA and CUDA's IEEE sqrtf return
    w = torch.sqrt((s * r).double()).to(s.dtype)
    h = s / torch.clamp_min(w, _EPS)
    half_w, half_h = w / 2.0, h / 2.0
    return torch.stack([u - half_w, v - half_h, u + half_w, v + half_h],
                       dim=1 if x.dim() == 3 else 0)


def xyxy_to_z_lane(box: torch.Tensor) -> torch.Tensor:
    """``box [D, 4, B]`` -> ``z [4, D, B]``."""
    x1, y1, x2, y2 = box[:, 0], box[:, 1], box[:, 2], box[:, 3]
    w = x2 - x1
    h = y2 - y1
    u = x1 + w / 2.0
    v = y1 + h / 2.0
    s = w * h
    r = w / torch.clamp_min(h, _EPS)
    return torch.stack([u, v, s, r], dim=0)


def iou_lane(det: torch.Tensor, trk: torch.Tensor) -> torch.Tensor:
    """``det [D, 4, B]``, ``trk [T, 4, B]`` -> IoU ``[D, T, B]``."""
    ax1, ay1, ax2, ay2 = (det[:, i, None] for i in range(4))   # [D, 1, B]
    bx1, by1, bx2, by2 = (trk[None, :, i] for i in range(4))   # [1, T, B]
    iw = torch.clamp_min(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1),
                         0.0)
    ih = torch.clamp_min(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                         0.0)
    inter = iw * ih
    ua = torch.clamp_min(ax2 - ax1, 0.0) * torch.clamp_min(ay2 - ay1, 0.0)
    ub = torch.clamp_min(bx2 - bx1, 0.0) * torch.clamp_min(by2 - by1, 0.0)
    return inter / torch.clamp_min(ua + ub - inter, 1e-9)


def frame_lane(x: torch.Tensor, p: torch.Tensor, det: torch.Tensor,
               det_mask: torch.Tensor, alive: torch.Tensor,
               iou_threshold: float = 0.3,
               active: torch.Tensor | None = None,
               assoc: str = "greedy",
               trk_to_det: torch.Tensor | None = None):
    """One whole SORT frame (predict -> IoU -> assign -> masked update) for
    the pure-IoU, single-class cost.

    ``x [7, T, S]``, ``p [49, T, S]``, ``det [D, 4, S]`` xyxy,
    ``det_mask [D, S]`` and ``alive [T, S]`` (bool or 0/1 float),
    ``active [1, S]`` (optional): lanes with ``active == 0`` are exact
    no-ops, their state restored after predict/update.

    ``assoc`` is ``"greedy"`` or ``"hungarian"``; a precomputed, already
    gated ``trk_to_det [T, S] int32`` skips the association instead.

    Returns ``(x, p, trk_to_det [T, S] int32, matched_det [D, S] bool)``.
    """
    x_in, p_in = x, p
    if active is not None:
        det_mask = det_mask * (active > 0)                  # [D,S] & [1,S]
    x, p = predict_lane(x, p)                               # [7,T,S], [49,T,S]
    if trk_to_det is not None:
        d = det.shape[0]
        di_iota = torch.arange(d, dtype=torch.int32,
                               device=det.device)[:, None, None]
        matched_det = (trk_to_det[None] == di_iota).any(dim=1)
    else:
        iou = iou_lane(det, z_to_xyxy_lane(x[:4]))          # [D, T, S]
        if assoc == "hungarian":
            trk_to_det, matched_det = association.associate_lane(
                iou, det_mask, alive, iou_threshold)
        elif assoc == "greedy":
            trk_to_det, matched_det = greedy.greedy_assign_lane(
                iou, det_mask, alive, iou_threshold)
        else:
            raise ValueError(f"unknown assoc {assoc!r}")
    # each matched tracker's observation; unmatched slots read zeros
    z_all = xyxy_to_z_lane(det)                             # [4, D, S]
    sel = trk_to_det >= 0
    idx = torch.where(sel, trk_to_det, 0).long()
    z_trk = torch.gather(z_all, 1, idx[None].expand(4, -1, -1))
    z_trk = torch.where(sel[None], z_trk, 0.0)              # [4, T, S]
    x, p = update_lane(x, p, z_trk, sel.to(x.dtype)[None])
    if active is not None:
        keep = (active > 0)[:, None]                        # [1, 1, S]
        x = torch.where(keep, x, x_in)
        p = torch.where(keep, p, p_in)
    return x, p, trk_to_det, matched_det
