"""Online multi-stream scheduler — ragged-length lane recycling.

Multiplexes an unbounded queue of ragged video sequences onto a fixed
budget of ``num_lanes`` engine lanes:

* **Admission** is FIFO: the moment a lane's sequence ends, the lane is
  recycled — masked re-init (``core.sort.reset_ragged``) plus the new
  sequence's first frame run in the *same* step.
* **Ragged stepping**: every step carries a per-lane ``active`` mask, so
  lanes between sequences are exact no-ops inside the kernel.
* **Chunked execution**: the host plans ``chunk`` steps at a time (the
  admission schedule depends only on queue order and lengths), sends the
  chunk's operands to the device once, runs them through
  ``SortEngine.run_chunk_ragged`` and reads the outputs back once.  The
  engine's config picks the dispatch: one ``fused_frame`` launch per step
  (FUSED) or one ``fused_chunk`` launch for the whole chunk
  (``chunk_kernel=True``, the MEGAKERNEL presets).  Planning, tracks and
  the counters (``lane_steps``, ``chunks_run``, ``utilization``) are the
  same under both.
* **Drain**: finished sequences come out **in submission order** through
  :class:`repro_torch.data.stream.ReorderBuffer`, each a dense
  :class:`repro_torch.data.stream.SequenceTracks` equal to a solo run of
  that sequence.

Elastic lane budgets, device meshes and state export/import are later
slices of the port; the constructor refuses them.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import slots
from ..core.sort import SortEngine
from ..data.stream import ReorderBuffer, SequenceTracks


@dataclasses.dataclass
class _Seq:
    """One submitted sequence and its in-flight output buffers."""

    index: int
    name: str
    det_boxes: np.ndarray          # [F, D, 4] padded to the scheduler's D
    det_mask: np.ndarray           # [F, D]
    boxes: list = dataclasses.field(default_factory=list)
    uid: list = dataclasses.field(default_factory=list)
    emit: list = dataclasses.field(default_factory=list)

    @property
    def length(self) -> int:
        return self.det_boxes.shape[0]


class StreamScheduler:
    """Multiplex ragged sequences onto ``num_lanes`` recycled engine lanes.

    Usage::

        sched = StreamScheduler(engine, num_lanes=2048, chunk=32)
        for name, db, dm in sequences:
            sched.submit(name, db, dm)
        for tracks in sched.run():      # submission order
            ...

    ``submit`` may be called again after ``run`` returns; lane state
    persists but every admission starts from a masked re-init.
    """

    def __init__(self, engine: SortEngine, num_lanes: int,
                 max_dets: Optional[int] = None, chunk: int = 32,
                 mesh=None, *, min_lanes: Optional[int] = None,
                 max_lanes: Optional[int] = None):
        if mesh is not None:
            raise NotImplementedError(
                "lane sharding over several devices is a later slice")
        if min_lanes is not None or max_lanes is not None:
            raise NotImplementedError(
                "elastic lane budgets (min_lanes/max_lanes) are a later "
                "slice; pass a fixed num_lanes")
        if num_lanes < 1:
            raise ValueError(f"num_lanes must be >= 1, got {num_lanes}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.engine = engine
        self.num_lanes = num_lanes
        self.max_dets = max_dets or engine.config.max_detections
        self.chunk = chunk

        self._pending: collections.deque[_Seq] = collections.deque()
        self._occupant: list[Optional[_Seq]] = [None] * num_lanes
        self._cursor = [0] * num_lanes
        self._ready = ReorderBuffer()
        self._num_submitted = 0

        # serving counters
        self.frames_processed = 0      # real sequence frames stepped
        # lanes x steps of steps that carried any planned work: the
        # all-idle tail of a draining final chunk is excluded
        self.lane_steps = 0
        self.chunks_run = 0
        self.admissions: list[tuple[int, int]] = []  # (seq index, step)
        self._state = engine.init_ragged(num_lanes)

    # --------------------------------------------------------------- intake
    def submit(self, name: str, det_boxes: np.ndarray,
               det_mask: np.ndarray) -> int:
        """Queue one sequence (``det_boxes [F, D_i, 4]``, ``det_mask
        [F, D_i]``); returns its submission index.  ``D_i`` must not exceed
        the scheduler's detection budget."""
        det_boxes = np.asarray(det_boxes, np.float32)
        det_mask = np.asarray(det_mask, bool)
        f, d_i = det_mask.shape
        if det_boxes.shape != (f, d_i, 4):
            raise ValueError(
                f"sequence {name!r}: det_boxes {det_boxes.shape} does not "
                f"match det_mask {det_mask.shape}")
        if d_i > self.max_dets:
            raise ValueError(
                f"sequence {name!r} has {d_i} detection slots, scheduler "
                f"budget is {self.max_dets}")
        if d_i < self.max_dets:
            pad = self.max_dets - d_i
            det_boxes = np.pad(det_boxes, ((0, 0), (0, pad), (0, 0)))
            det_mask = np.pad(det_mask, ((0, 0), (0, pad)))
        seq = _Seq(self._num_submitted, name, det_boxes, det_mask)
        self._num_submitted += 1
        if f == 0:  # nothing to step; complete immediately (still in order)
            self._finalize(seq)
        else:
            self._pending.append(seq)
        return seq.index

    @property
    def busy(self) -> bool:
        """True while queued or in-flight sequences, or finished results
        held for in-order release, remain."""
        return self._has_step_work or len(self._ready) > 0

    @property
    def _has_step_work(self) -> bool:
        return bool(self._pending) or any(
            s is not None for s in self._occupant)

    @property
    def utilization(self) -> float:
        """Fraction of working lane-steps that carried a real frame."""
        return self.frames_processed / max(self.lane_steps, 1)

    # ------------------------------------------------------------- planning
    def _plan_chunk(self):
        """Plan the next ``chunk`` steps of the lane schedule on the host,
        mid-chunk recycling included."""
        c, l, d = self.chunk, self.num_lanes, self.max_dets
        det = np.zeros((c, l, d, 4), np.float32)
        dm = np.zeros((c, l, d), bool)
        active = np.zeros((c, l), bool)
        reset = np.zeros((c, l), bool)
        mapping = []                                  # (t, lane, seq, frame)
        for t in range(c):
            for lane in range(l):
                if self._occupant[lane] is None and self._pending:
                    self._occupant[lane] = self._pending.popleft()
                    self._cursor[lane] = 0
                    reset[t, lane] = True             # recycle in this step
                    self.admissions.append(
                        (self._occupant[lane].index,
                         self.chunks_run * self.chunk + t))
                seq = self._occupant[lane]
                if seq is None:
                    continue
                k = self._cursor[lane]
                det[t, lane] = seq.det_boxes[k]
                dm[t, lane] = seq.det_mask[k]
                active[t, lane] = True
                mapping.append((t, lane, seq, k))
                self._cursor[lane] = k + 1
                if k + 1 == seq.length:               # lane free next step
                    self._occupant[lane] = None
        return det, dm, active, reset, mapping

    # ------------------------------------------------------------ execution
    def _run_chunk(self) -> list[SequenceTracks]:
        if not self._has_step_work:
            return self._ready.pop_ready()
        det, dm, active, reset, mapping = self._plan_chunk()
        dev = self.engine.device
        operands = tuple(torch.from_numpy(a).to(dev)
                         for a in (det, dm, active, reset))
        self._state, outs = self.engine.run_chunk_ragged(self._state,
                                                         *operands)
        self._check_uid_headroom()
        boxes = outs.boxes.cpu().numpy()              # [C, L, T, 4]
        uid = outs.uid.cpu().numpy()
        emit = outs.emit.cpu().numpy()
        finished = []
        for t, lane, seq, k in mapping:
            # copies, so a buffered row doesn't pin the whole chunk array
            seq.boxes.append(boxes[t, lane].copy())
            seq.uid.append(uid[t, lane].copy())
            seq.emit.append(emit[t, lane].copy())
            if k + 1 == seq.length:
                finished.append(seq)
        self.frames_processed += len(mapping)
        self.lane_steps += int(active.any(axis=1).sum()) * self.num_lanes
        self.chunks_run += 1
        for seq in finished:
            self._finalize(seq)
        return self._ready.pop_ready()

    def _finalize(self, seq: _Seq) -> None:
        t = self.engine.config.max_trackers
        self._ready.put(seq.index, SequenceTracks(
            name=seq.name,
            boxes=(np.stack(seq.boxes) if seq.boxes
                   else np.zeros((0, t, 4), np.float32)),
            uid=(np.stack(seq.uid) if seq.uid
                 else np.zeros((0, t), np.int32)),
            emit=(np.stack(seq.emit) if seq.emit
                  else np.zeros((0, t), bool)),
        ))

    def _check_uid_headroom(self) -> None:
        """Refuse to go on once a lane's int32 uid counter crosses
        ``slots.UID_LIMIT`` (it resets on every admission, so only a single
        monster sequence can get there); wrapping would alias live ids."""
        next_uid = self._state.pool.next_uid.cpu().numpy()
        if next_uid.size and int(next_uid.max()) > slots.UID_LIMIT:
            lane = int(next_uid.argmax())
            raise RuntimeError(
                f"track uid counter on lane {lane} exceeded "
                f"slots.UID_LIMIT ({slots.UID_LIMIT}): a single sequence "
                f"allocated ~2**31 track ids.  uids are int32 and only "
                f"reset when the lane is recycled; split the sequence or "
                f"re-admit it to reset its uid namespace.")

    def pop_ready(self) -> list[SequenceTracks]:
        """Release every finished sequence whose turn has come, without
        running anything."""
        return self._ready.pop_ready()

    def run_chunk(self) -> list[SequenceTracks]:
        """Run (at most) one planned chunk and release whatever finished."""
        return self._run_chunk()

    def drain(self) -> list[SequenceTracks]:
        """Run chunks until no step work remains, then release everything
        buffered; returns the newly finished sequences in submission
        order.  Never runs an empty chunk."""
        results = []
        while self._has_step_work:
            results.extend(self._run_chunk())
        results.extend(self.pop_ready())
        return results

    def run(self) -> list[SequenceTracks]:
        """Process every submitted sequence to completion, returning their
        track streams in submission order."""
        return self.drain()
