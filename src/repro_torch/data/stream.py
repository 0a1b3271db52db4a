"""Draining finished sequences in submission order.

:class:`SequenceTracks` is one finished sequence's dense track stream and
:class:`ReorderBuffer` releases out-of-order completions in submission
order — the scheduler's drain contract.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SequenceTracks:
    """One finished sequence's track stream, dense over its own frames.

    ``boxes [F_i, T, 4]`` xyxy, ``uid [F_i, T]`` int32, ``emit [F_i, T]``
    bool — the rows of :class:`repro_torch.core.sort.SortOutput` that
    belonged to this sequence, in frame order, exactly as a solo run would
    have produced them (the ragged scheduler's lane-recycling invariant).
    ``cls [F_i, T]`` int32 carries each slot's track class; ``None`` for
    single-class serving.
    """

    name: str
    boxes: np.ndarray
    uid: np.ndarray
    emit: np.ndarray
    cls: np.ndarray | None = None

    @property
    def num_frames(self) -> int:
        return self.boxes.shape[0]


class ReorderBuffer:
    """In-order release of out-of-order completions.

    Sequences multiplexed over recycled lanes finish in length order, not
    submission order; ``put(index, item)`` parks a completion and
    ``pop_ready()`` releases the longest run of consecutively-indexed items
    starting at the watermark — so consumers (result writers, metric
    aggregators) always observe submission order, the scheduler's
    drain/flush contract.
    """

    def __init__(self, start: int = 0):
        self._next = start
        self._held: dict[int, object] = {}

    @property
    def next_index(self) -> int:
        """The watermark: the submission index the next release starts at.
        Everything below it has already been released."""
        return self._next

    @property
    def held_indices(self) -> tuple[int, ...]:
        """Indices parked above the watermark, ascending."""
        return tuple(sorted(self._held))

    def put(self, index: int, item) -> None:
        if index < self._next or index in self._held:
            raise ValueError(f"sequence index {index} already released")
        self._held[index] = item

    def peek(self, index: int):
        """The parked item at ``index`` without releasing it."""
        return self._held[index]

    def pop_ready(self) -> list:
        out = []
        while self._next in self._held:
            out.append(self._held.pop(self._next))
            self._next += 1
        return out

    def __len__(self) -> int:
        return len(self._held)
