"""SORT — Simple Online and Real-time Tracking, batched over streams.

One frame for every stream (paper Fig. 2): Kalman-predict every tracker,
associate the predicted boxes with the frame's detections (Hungarian or
greedy on IoU), Kalman-update the matched trackers, age and kill the
unmatched ones, birth trackers from unmatched detections, and emit the
confirmed tracks.  Lifecycle constants follow Bewley's reference
implementation (``max_age=1``, ``min_hits=3``, ``iou_threshold=0.3``).

This module runs the lane-persistent fused path (``use_kernels=True``):
the state lives in the kernels' lane layout (:class:`LaneSortState`) and
predict/associate/update run as one launch of
:func:`repro_torch.kernels.frame.fused_frame` per frame, fed by the
lane-batched Hungarian stage when ``assoc="hungarian"``.  Streams are not
padded: the kernel masks its own ragged edge.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from . import kalman, slots
from . import cost as cost_mod
from ..kernels import ops as kops
from ..kernels import ref as kref


@dataclasses.dataclass(frozen=True)
class SortConfig:
    max_trackers: int = 16     # slot capacity T (Table I's max is 13 objects)
    max_detections: int = 16   # padded detections per frame D
    iou_threshold: float = 0.3
    max_age: int = 1
    min_hits: int = 3
    dtype: str = "float32"
    # association algorithm: "hungarian" (the paper's) or "greedy"
    assoc: str = "hungarian"
    # True -> lane-persistent fused frame path, the only path ported so far
    use_kernels: bool = False
    # the reference's TPU stream block; unused here (no stream padding)
    block_b: int = 2048
    # True -> one launch per serving chunk (not ported yet)
    chunk_kernel: bool = False
    # association cost; only the pure-IoU spec is ported so far
    cost: cost_mod.CostSpec = cost_mod.IOU
    num_classes: int = 1


class SortState(NamedTuple):
    x: torch.Tensor        # [S, T, 7]  Kalman means
    p: torch.Tensor        # [S, T, 7, 7] covariances
    pool: slots.SlotPool   # [S, T] lifecycle
    frame_count: torch.Tensor  # [S] int32
    embed: torch.Tensor = None  # [S, T, E] (E = 0: no appearance term)


class LaneSortState(NamedTuple):
    """Persistent lane-layout engine state.

    The tracker batch ``B = T * S`` is **tracker-slot major**: lane
    ``b = t * S + s``, so ``x.reshape(7, T, S)`` is a free view with
    streams on the minor axis — the fused frame kernel's operand layout.
    ``pool`` fields are lane-major ``[T, S]``; ``frame_count [S]``.
    """

    x: torch.Tensor        # [7, B]
    p: torch.Tensor        # [49, B]  row-major 7x7
    pool: slots.SlotPool   # [T, S]
    frame_count: torch.Tensor  # [S] int32
    embed: torch.Tensor = None  # [E, B]


class SortOutput(NamedTuple):
    boxes: torch.Tensor        # [S, T, 4] xyxy of every slot after births
    uid: torch.Tensor          # [S, T] track id, -1 if dead
    emit: torch.Tensor         # [S, T] bool — confirmed tracks to report
    matched_det: torch.Tensor  # [S, D] bool
    cls: torch.Tensor = None   # [S, T] int32 class per slot, -1 if dead


def lane_state_of(state: SortState) -> LaneSortState:
    """Engine layout -> persistent lane layout (exact)."""
    s, t = state.x.shape[0], state.x.shape[1]
    e = state.embed.shape[-1]
    return LaneSortState(
        x=state.x.permute(2, 1, 0).reshape(kalman.DIM_X, t * s),
        p=state.p.reshape(s, t, 49).permute(2, 1, 0).reshape(49, t * s),
        pool=slots.transpose_pool(state.pool),
        frame_count=state.frame_count,
        embed=state.embed.permute(2, 1, 0).reshape(e, t * s),
    )


def sort_state_of(lane: LaneSortState) -> SortState:
    """Persistent lane layout -> engine layout (exact inverse of
    :func:`lane_state_of`)."""
    t, s = lane.pool.alive.shape
    e = lane.embed.shape[0]
    return SortState(
        x=lane.x.reshape(kalman.DIM_X, t, s).permute(2, 1, 0),
        p=lane.p.reshape(49, t, s).permute(2, 1, 0).reshape(
            s, t, kalman.DIM_X, kalman.DIM_X),
        pool=slots.transpose_pool(lane.pool),
        frame_count=lane.frame_count,
        embed=lane.embed.reshape(e, t, s).permute(2, 1, 0))


_POOL_SLOT_FIELDS = ("alive", "age", "hits", "hit_streak",
                     "time_since_update", "uid", "cls")


def _select_pool(slot_mask: torch.Tensor, stream_mask: torch.Tensor,
                 new: slots.SlotPool, old: slots.SlotPool) -> slots.SlotPool:
    """Per-stream pool select: ``new`` where the mask holds, else ``old``.
    ``slot_mask`` broadcasts over the slot fields, ``stream_mask`` over the
    per-stream uid counter."""
    return new._replace(
        **{f: torch.where(slot_mask, getattr(new, f), getattr(old, f))
           for f in _POOL_SLOT_FIELDS},
        next_uid=torch.where(stream_mask, new.next_uid, old.next_uid))


def _reset_pool(pool: slots.SlotPool, reset_lane_major: torch.Tensor,
                reset_streams_: torch.Tensor,
                uid_start: int = 1) -> slots.SlotPool:
    """Masked pool re-init (``slots.init_pool``'s values, applied in
    place): ``reset_lane_major`` broadcasts over the slot fields,
    ``reset_streams_`` over the per-stream uid counter."""
    return slots.SlotPool(
        alive=torch.where(reset_lane_major, False, pool.alive),
        age=torch.where(reset_lane_major, 0, pool.age),
        hits=torch.where(reset_lane_major, 0, pool.hits),
        hit_streak=torch.where(reset_lane_major, 0, pool.hit_streak),
        time_since_update=torch.where(reset_lane_major, 0,
                                      pool.time_since_update),
        uid=torch.where(reset_lane_major, -1, pool.uid),
        cls=torch.where(reset_lane_major, -1, pool.cls),
        next_uid=torch.where(reset_streams_, uid_start, pool.next_uid),
    )


def reset_lanes(lane: LaneSortState, reset: torch.Tensor,
                uid_start: int = 1) -> LaneSortState:
    """Masked re-init of whole streams: streams with ``reset [S]`` True
    return to the freshly initialised state (zero means, initial
    covariance, empty pool, ``next_uid=uid_start``, ``frame_count=0``);
    every other stream is untouched.  This is how the scheduler recycles a
    lane for a newly admitted sequence."""
    t, s = lane.pool.alive.shape
    r_lane = reset[None, :]                                      # [1, S]
    x3 = lane.x.reshape(kalman.DIM_X, t, s)
    p3 = lane.p.reshape(49, t, s)
    p0 = kalman.initial_covariance(lane.p.dtype, lane.p.device).reshape(49)
    x3 = torch.where(r_lane[None], 0.0, x3)
    p3 = torch.where(r_lane[None], p0[:, None, None], p3)
    e = lane.embed.shape[0]
    e3 = torch.where(r_lane[None], 0.0, lane.embed.reshape(e, t, s))
    return LaneSortState(
        x=x3.reshape(kalman.DIM_X, t * s),
        p=p3.reshape(49, t * s),
        pool=_reset_pool(lane.pool, r_lane, reset, uid_start),
        frame_count=torch.where(reset, 0, lane.frame_count),
        embed=e3.reshape(e, t * s),
    )


def reset_ragged(state: LaneSortState, reset: torch.Tensor,
                 uid_start: int = 1) -> LaneSortState:
    """The scheduler's masked re-init (the fused path keeps the lane
    layout, so this is :func:`reset_lanes`)."""
    if not isinstance(state, LaneSortState):
        raise TypeError(f"expected a LaneSortState, got {type(state)}")
    return reset_lanes(state, reset, uid_start)


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Asking for CUDA where there is none
    raises instead of quietly running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


class SortEngine:
    """Batched SORT over ``S`` independent streams on one device.

    ``device=None`` runs on the card and raises when CUDA is absent; pass
    ``device="cpu"`` for the plain PyTorch path.  ``frame_mode`` is the
    default backend of :func:`repro_torch.kernels.ops.frame_step`:
    ``"auto"`` (the kernel for CUDA tensors, the plain version for CPU
    ones), ``"ref"`` (the plain version on any device) or ``"kernel"``.
    """

    def __init__(self, config: SortConfig, device=None,
                 frame_mode: str = "auto"):
        if config.assoc not in ("hungarian", "greedy"):
            raise ValueError(
                f"SortConfig.assoc must be 'hungarian' or 'greedy', "
                f"got {config.assoc!r}")
        if not config.use_kernels:
            raise NotImplementedError(
                "use_kernels=False is the per-phase engine path, ported in "
                "the slice of the per-phase kernels (kalman_fused, iou_cost)")
        if config.chunk_kernel:
            raise NotImplementedError(
                "chunk_kernel=True runs kernels/chunk.py::fused_chunk, "
                "ported in the next slice")
        if config.num_classes != 1 or not config.cost.is_iou_only:
            raise NotImplementedError(
                "only the single-class pure-IoU cost is ported; class "
                "partitions and composed costs come with the multi-class "
                "slice")
        if frame_mode not in ("auto", "ref", "kernel"):
            raise ValueError(f"unknown frame_mode {frame_mode!r}")
        self.config = config
        self.device = resolve_device(device)
        self.dtype = getattr(torch, config.dtype)
        self.frame_mode = frame_mode

    # ------------------------------------------------------------------ state
    def init(self, num_streams: int) -> SortState:
        cfg, dev, dt = self.config, self.device, self.dtype
        t = cfg.max_trackers
        p0 = kalman.initial_covariance(dt, dev)
        return SortState(
            x=torch.zeros((num_streams, t, kalman.DIM_X), dtype=dt,
                          device=dev),
            p=p0.expand(num_streams, t, kalman.DIM_X, kalman.DIM_X).clone(),
            pool=slots.init_pool((num_streams,), t, device=dev),
            frame_count=torch.zeros((num_streams,), dtype=torch.int32,
                                    device=dev),
            embed=torch.zeros((num_streams, t, cfg.cost.embed_dim), dtype=dt,
                              device=dev),
        )

    def init_ragged(self, num_lanes: int) -> LaneSortState:
        """Initial lane-layout state for :meth:`step_ragged`."""
        return lane_state_of(self.init(num_lanes))

    # ------------------------------------------------------------------- step
    def step(self, state: SortState, det_boxes: torch.Tensor,
             det_mask: torch.Tensor) -> tuple[SortState, SortOutput]:
        """One frame for every stream, in the engine layout.

        ``det_boxes [S, D, 4]`` xyxy, ``det_mask [S, D]`` bool.  Converts to
        the lane layout and back around :meth:`lane_step`; :meth:`run`
        converts once per video.
        """
        lane, out = self.lane_step(lane_state_of(state), det_boxes, det_mask)
        return sort_state_of(lane), out

    def lane_step(self, lane: LaneSortState, det_boxes: torch.Tensor,
                  det_mask: torch.Tensor,
                  stream_active: Optional[torch.Tensor] = None,
                  ) -> tuple[LaneSortState, SortOutput]:
        """One frame entirely in the persistent lane layout.

        Predict -> association -> masked update is one launch of the fused
        frame kernel (fed by the Hungarian stage); tick, births and emit
        are lane-major integer work.  ``stream_active [S]`` bool (optional)
        marks the streams that carry a frame: the others are exact no-ops —
        state, lifecycle and ``frame_count`` untouched, nothing emitted.
        """
        cfg = self.config
        s = det_boxes.shape[0]
        t = cfg.max_trackers
        dt = lane.x.dtype
        x3 = lane.x.reshape(kalman.DIM_X, t, s)
        p3 = lane.p.reshape(49, t, s)
        det_l = det_boxes.to(dt).permute(1, 2, 0).contiguous()  # [D, 4, S]
        dm_l = det_mask.T                                        # [D, S] bool
        act = stream_active                                      # [S] bool

        # 1-3. predict + associate + masked update: one kernel launch
        x3, p3, trk_to_det, matched_det = kops.frame_step(
            x3, p3, det_l, dm_l.to(dt).contiguous(),
            lane.pool.alive.to(dt).contiguous(),
            None if act is None else act.to(dt)[None],
            iou_threshold=cfg.iou_threshold,
            mode=self.frame_mode, assoc=cfg.assoc)

        # 4a. age & kill (elementwise, lane-major as is)
        pool = slots.tick(lane.pool, trk_to_det >= 0, cfg.max_age)

        # 4b. births from unmatched detections into free slots
        unmatched_det = dm_l & ~matched_det
        if act is not None:
            unmatched_det = unmatched_det & act[None]
        slot_for = slots.assign_slots_lane(~pool.alive, unmatched_det)
        pool = slots.birth_lane(pool, slot_for)
        z_det = kref.xyxy_to_z_lane(det_l)                       # [4, D, S]
        slot_iota = torch.arange(t, dtype=torch.int32, device=x3.device)
        # claimed slots are distinct, so each born slot has one claimant
        sel = slot_for[:, None, :] == slot_iota[None, :, None]   # [D, T, S]
        born = sel.any(dim=0)                                    # [T, S]
        claimant = torch.argmax(sel.to(torch.int32), dim=0)      # [T, S]
        zb = torch.gather(z_det, 1, claimant[None].expand(4, -1, -1))
        zb = torch.where(born[None], zb, 0.0)
        x_init = torch.cat([zb, torch.zeros((3, t, s), dtype=dt,
                                            device=x3.device)], dim=0)
        p_init = kalman.initial_covariance(dt, x3.device).reshape(49)
        x3 = torch.where(born[None], x_init, x3)
        p3 = torch.where(born[None], p_init[:, None, None], p3)

        if act is not None:
            # inactive lanes: lifecycle freezes (the kernel left x/p as
            # they were, and no match or birth happened above)
            pool = _select_pool(act[None], act, pool, lane.pool)
            frame_count = lane.frame_count + act.to(torch.int32)
        else:
            frame_count = lane.frame_count + 1

        # 5. emit: updated this frame AND (probation passed OR warmup)
        warmup = (frame_count <= cfg.min_hits)[None]             # [1, S]
        emit = (pool.alive
                & (pool.time_since_update < 1)
                & ((pool.hit_streak >= cfg.min_hits) | warmup))
        if act is not None:
            emit = emit & act[None]

        boxes_l = kref.z_to_xyxy_lane(x3[:4])                    # [T, 4, S]
        out = SortOutput(boxes=boxes_l.permute(2, 0, 1),
                         uid=pool.uid.T, emit=emit.T,
                         matched_det=matched_det.T, cls=pool.cls.T)
        lane = LaneSortState(x3.reshape(kalman.DIM_X, t * s),
                             p3.reshape(49, t * s), pool, frame_count,
                             lane.embed)
        return lane, out

    # ------------------------------------------------------ ragged stepping
    def step_ragged(self, state: LaneSortState, det_boxes: torch.Tensor,
                    det_mask: torch.Tensor, active: torch.Tensor):
        """One frame for a ragged multiplex of sequences over fixed lanes:
        ``det_boxes [L, D, 4]``, ``det_mask [L, D]``, ``active [L]`` bool.
        Lanes with ``active=False`` are exact no-ops."""
        return self.lane_step(state, det_boxes, det_mask,
                              stream_active=active)

    def run_chunk_ragged(self, state: LaneSortState, det_boxes: torch.Tensor,
                         det_mask: torch.Tensor, active: torch.Tensor,
                         reset: torch.Tensor):
        """One planned serving chunk of ``F`` ragged steps.

        ``det_boxes [F, L, D, 4]``, ``det_mask [F, L, D]``, ``active
        [F, L]`` and ``reset [F, L]`` bool; ``reset[f, l]`` recycles lane
        ``l`` in the step that carries the admitted sequence's first frame.
        Returns ``(state, SortOutput stacked over F)``.  One kernel launch
        per frame.
        """
        outs = []
        for f in range(det_boxes.shape[0]):
            state = reset_ragged(state, reset[f])
            state, out = self.step_ragged(state, det_boxes[f], det_mask[f],
                                          active[f])
            outs.append(out)
        return state, _stack_outputs(outs)

    # -------------------------------------------------------------------- run
    def run(self, state: SortState, frames: torch.Tensor,
            frame_masks: torch.Tensor) -> tuple[SortState, SortOutput]:
        """Every frame of ``frames [F, S, D, 4]`` / ``frame_masks
        [F, S, D]``, with the state in the lane layout throughout;
        outputs stacked over ``F``."""
        lane = lane_state_of(state)
        outs = []
        for f in range(frames.shape[0]):
            lane, out = self.lane_step(lane, frames[f], frame_masks[f])
            outs.append(out)
        return sort_state_of(lane), _stack_outputs(outs)


def _stack_outputs(outs: list) -> SortOutput:
    return SortOutput(*(torch.stack(fields) for fields in zip(*outs)))
