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
and :func:`repro_torch.kernels.chunk.fused_chunk` and the yardstick they
are held against on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import association, greedy, kalman
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


# ------------------------------------------------------------------------
# Chunk-resident execution: the whole serving step — masked lane re-init,
# fused frame, tracker lifecycle, emit — in the lane layout, the body of
# :func:`repro_torch.kernels.chunk.fused_chunk` and its plain version.
# Repeats the reference's ``step_chunk_lane`` op for op (IoU cost, one
# class), so a chunk equals F per-frame engine steps bit for bit.
# ------------------------------------------------------------------------
class ChunkState(NamedTuple):
    """Per-lane SORT state as a flat bundle of numeric tensors, the state
    the chunk kernel carries across its frame loop.

    Every lifecycle field is int32 (``alive`` included: 0/1); per-stream
    counters carry a leading unit axis: ``x [7, T, S]``, ``p [49, T, S]``,
    slot fields ``[T, S]``, ``next_uid``/``frame_count`` ``[1, S]``.
    ``embed`` is ``[0, T, S]``: the port has no appearance term yet.
    ``core.sort.chunk_state_of`` / ``lane_state_of_chunk`` convert exactly.
    """

    x: torch.Tensor                  # [7, T, S]  Kalman means
    p: torch.Tensor                  # [49, T, S] covariances
    alive: torch.Tensor              # [T, S] int32 0/1
    age: torch.Tensor                # [T, S] int32
    hits: torch.Tensor               # [T, S] int32
    hit_streak: torch.Tensor         # [T, S] int32
    time_since_update: torch.Tensor  # [T, S] int32
    uid: torch.Tensor                # [T, S] int32, -1 when dead
    cls: torch.Tensor                # [T, S] int32 class, -1 when dead
    next_uid: torch.Tensor           # [1, S] int32
    frame_count: torch.Tensor        # [1, S] int32
    embed: torch.Tensor              # [0, T, S]


class ChunkOuts(NamedTuple):
    """Per-frame outputs of the chunk body, stacked ``[F, ...]`` by
    :func:`chunk_lane`."""

    boxes: torch.Tensor        # [T, 4, S]
    uid: torch.Tensor          # [T, S] int32
    emit: torch.Tensor         # [T, S] bool (int32 from the kernel)
    trk_to_det: torch.Tensor   # [T, S] int32
    matched_det: torch.Tensor  # [D, S] bool (int32 from the kernel)
    cls: torch.Tensor          # [T, S] int32 track class, -1 when dead


def assign_slots_lane_unrolled(free_mask: torch.Tensor,
                               want_mask: torch.Tensor) -> torch.Tensor:
    """:func:`repro_torch.core.slots.assign_slots_lane` by unrolled
    compare and accumulate: the k-th claimant takes the k-th free slot, -1
    when the pool is exhausted.  ``free [T, ...]``, ``want [D, ...]`` bool
    -> ``slot_for [D, ...] int32``, integer-exact against the scatter
    version."""
    t, d = free_mask.shape[0], want_mask.shape[0]
    zero = torch.zeros(free_mask.shape[1:], dtype=torch.int32,
                       device=free_mask.device)
    free_rank = []                    # free slots with index < ti
    num_free = zero
    for ti in range(t):
        free_rank.append(num_free)
        num_free = num_free + free_mask[ti].to(torch.int32)
    want_rank = []                    # claimants with index < di
    acc = zero
    for di in range(d):
        want_rank.append(acc)
        acc = acc + want_mask[di].to(torch.int32)
    rows = []
    for di in range(d):
        ok = want_mask[di] & (want_rank[di] < num_free)
        slot = torch.full(free_mask.shape[1:], -1, dtype=torch.int32,
                          device=free_mask.device)
        for ti in range(t):
            hit = free_mask[ti] & (free_rank[ti] == want_rank[di])
            slot = torch.where(ok & hit, ti, slot)
        rows.append(slot)
    if not rows:
        return torch.zeros((0,) + free_mask.shape[1:], dtype=torch.int32,
                           device=free_mask.device)
    return torch.stack(rows, dim=0)


def step_chunk_lane(state: ChunkState, det: torch.Tensor,
                    det_mask: torch.Tensor, active: torch.Tensor,
                    reset: torch.Tensor,
                    trk_to_det: torch.Tensor | None = None, *,
                    iou_threshold: float = 0.3, max_age: int = 1,
                    min_hits: int = 3, assoc: str = "greedy"):
    """One serving step of the chunk body: masked lane re-init, fused
    predict/associate/update, tick, births, inactive-lane freeze, emit.

    ``det [D, 4, S]`` xyxy, ``det_mask [D, S]`` and ``active [1, S]`` 0/1
    float, ``reset [1, S]`` 0/1 numeric; ``trk_to_det [T, S] int32``
    (optional) is a precomputed, gated assignment that replaces the
    association.  Returns ``(ChunkState, ChunkOuts)``.
    """
    from ..core import slots

    dt = state.x.dtype
    dev = state.x.device
    t = state.alive.shape[0]
    d = det.shape[0]
    act = active[0] > 0                                      # [S]
    rst = reset[0] > 0                                       # [S]

    # masked lane re-init (uid_start=1): a recycled lane and its admitted
    # sequence's first frame share the step
    p0 = kalman.initial_covariance(dt, dev).reshape(49)[:, None, None]
    x = torch.where(rst[None, None], 0.0, state.x)
    p = torch.where(rst[None, None], p0, state.p)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    alive0 = (state.alive > 0) & ~rst[None]
    pool0 = slots.SlotPool(
        alive=alive0,
        age=torch.where(rst[None], zero, state.age),
        hits=torch.where(rst[None], zero, state.hits),
        hit_streak=torch.where(rst[None], zero, state.hit_streak),
        time_since_update=torch.where(rst[None], zero,
                                      state.time_since_update),
        uid=torch.where(rst[None], -1, state.uid),
        cls=torch.where(rst[None], -1, state.cls),
        next_uid=torch.where(rst, 1, state.next_uid[0]),     # [S]
    )
    fc0 = torch.where(rst, zero, state.frame_count[0])       # [S]

    # 1-3. fused predict + IoU + assign + masked update (inactive lanes
    # restored inside)
    x, p, t2d, matched = frame_lane(
        x, p, det, det_mask, alive0.to(dt), iou_threshold,
        active=active, assoc=assoc, trk_to_det=trk_to_det)

    # 4a. age & kill
    pool = slots.tick(pool0, t2d >= 0, max_age)

    # 4b. births from unmatched detections into free slots
    unmatched = (det_mask > 0) & ~matched & act[None]
    slot_for = assign_slots_lane_unrolled(~pool.alive, unmatched)
    z_det = xyxy_to_z_lane(det)                              # [4, D, S]
    claimed = slot_for >= 0
    born_order = []                                          # claimants < di
    n_born = torch.zeros(slot_for.shape[1:], dtype=torch.int32, device=dev)
    for di in range(d):
        born_order.append(n_born)
        n_born = n_born + claimed[di].to(torch.int32)
    born_rows, uid_rows, cls_rows, zb_rows = [], [], [], []
    for ti in range(t):
        sel_any = torch.zeros(slot_for.shape[1:], dtype=torch.bool,
                              device=dev)
        uid_t = pool.uid[ti]
        cls_t = pool.cls[ti]
        zb_t = torch.zeros((4,) + slot_for.shape[1:], dtype=dt, device=dev)
        for di in range(d):
            sel = slot_for[di] == ti      # claimed slots are distinct
            sel_any = sel_any | sel
            uid_t = torch.where(sel, pool.next_uid + born_order[di], uid_t)
            cls_t = torch.where(sel, zero, cls_t)
            zb_t = torch.where(sel[None], z_det[:, di], zb_t)
        born_rows.append(sel_any)
        uid_rows.append(uid_t)
        cls_rows.append(cls_t)
        zb_rows.append(zb_t)
    born = torch.stack(born_rows, dim=0)                     # [T, S]
    zb = torch.stack(zb_rows, dim=1)                         # [4, T, S]
    pool = slots.SlotPool(
        alive=pool.alive | born,
        age=torch.where(born, zero, pool.age),
        hits=torch.where(born, zero, pool.hits),
        hit_streak=torch.where(born, zero, pool.hit_streak),
        time_since_update=torch.where(born, zero, pool.time_since_update),
        uid=torch.stack(uid_rows, dim=0),
        cls=torch.stack(cls_rows, dim=0),
        next_uid=pool.next_uid + n_born,
    )
    x_init = torch.cat([zb, torch.zeros((3,) + zb.shape[1:], dtype=dt,
                                        device=dev)], 0)
    x = torch.where(born[None], x_init, x)
    p = torch.where(born[None], p0, p)

    # inactive lanes: lifecycle freezes (x/p were restored inside
    # frame_lane; births cannot fire: `unmatched` was gated by act)
    def sel(new, old):
        return torch.where(act[None], new, old)

    pool = slots.SlotPool(
        alive=sel(pool.alive, pool0.alive),
        age=sel(pool.age, pool0.age),
        hits=sel(pool.hits, pool0.hits),
        hit_streak=sel(pool.hit_streak, pool0.hit_streak),
        time_since_update=sel(pool.time_since_update,
                              pool0.time_since_update),
        uid=sel(pool.uid, pool0.uid),
        cls=sel(pool.cls, pool0.cls),
        next_uid=torch.where(act, pool.next_uid, pool0.next_uid),
    )
    fc = fc0 + act.to(torch.int32)                           # [S]

    # 5. emit: updated this frame AND (probation passed OR warmup)
    warmup = (fc <= min_hits)[None]                          # [1, S]
    emit = (pool.alive & (pool.time_since_update < 1)
            & ((pool.hit_streak >= min_hits) | warmup) & act[None])
    new_state = ChunkState(
        x=x, p=p, alive=pool.alive.to(torch.int32), age=pool.age,
        hits=pool.hits, hit_streak=pool.hit_streak,
        time_since_update=pool.time_since_update, uid=pool.uid,
        cls=pool.cls, next_uid=pool.next_uid[None, :],
        frame_count=fc[None, :], embed=state.embed)
    outs = ChunkOuts(boxes=z_to_xyxy_lane(x[:4]), uid=pool.uid, emit=emit,
                     trk_to_det=t2d, matched_det=matched, cls=pool.cls)
    return new_state, outs


def chunk_lane(state: ChunkState, det: torch.Tensor, det_mask: torch.Tensor,
               active: torch.Tensor, reset: torch.Tensor,
               trk_to_det: torch.Tensor | None = None, *,
               iou_threshold: float = 0.3, max_age: int = 1,
               min_hits: int = 3, assoc: str = "greedy"):
    """:func:`step_chunk_lane` over the frame axis: ``det [F, D, 4, S]``,
    ``det_mask [F, D, S]``, ``active``/``reset`` ``[F, 1, S]``, optional
    ``trk_to_det [F, T, S] int32``.  Returns ``(ChunkState, ChunkOuts
    stacked over F)``."""
    outs = []
    for f in range(det.shape[0]):
        state, out = step_chunk_lane(
            state, det[f], det_mask[f], active[f], reset[f],
            None if trk_to_det is None else trk_to_det[f],
            iou_threshold=iou_threshold, max_age=max_age,
            min_hits=min_hits, assoc=assoc)
        outs.append(out)
    return state, ChunkOuts(*(torch.stack(v) for v in zip(*outs)))
