"""Fixed-capacity tracker slot pools — static-shape lifecycle management.

Each stream owns ``T`` tracker slots with an ``alive`` mask; births claim
free slots and deaths free them without changing any shape.  The engine
keeps pools lane-major (slot fields ``[T, S]``); :func:`init_pool` builds
them engine-major (``[S, T]``) and :func:`transpose_pool` swaps the two.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# ``next_uid`` is a per-stream int32 counter that only resets when the
# stream is re-initialised (every scheduler admission).  Births allocate at
# most D uids per frame, so a counter below this limit cannot reach int32
# overflow within any chunk the scheduler dispatches; the scheduler raises
# once a lane crosses it rather than wrap onto ids that may still be alive.
UID_LIMIT = 2**31 - 2**20

_SLOT_FIELDS = ("alive", "age", "hits", "hit_streak", "time_since_update",
                "uid", "cls")


class SlotPool(NamedTuple):
    """Per-slot lifecycle bookkeeping; every int field is int32.

    ``alive`` (bool): slot holds a live tracker.  ``age``: steps since
    birth.  ``hits``: total matches.  ``hit_streak``: consecutive matches.
    ``time_since_update``: steps since the last match.  ``uid``: per-stream
    track id, -1 when dead.  ``cls``: track class, -1 when dead (0 for
    single-class births).  ``next_uid``: per-stream id counter (no slot
    axis).
    """

    alive: torch.Tensor
    age: torch.Tensor
    hits: torch.Tensor
    hit_streak: torch.Tensor
    time_since_update: torch.Tensor
    uid: torch.Tensor
    cls: torch.Tensor
    next_uid: torch.Tensor


def init_pool(batch_shape: tuple, capacity: int, uid_start: int = 1,
              device=None) -> SlotPool:
    """An empty engine-major pool: slot fields ``batch_shape + (T,)``."""
    shape = tuple(batch_shape) + (capacity,)
    z = torch.zeros(shape, dtype=torch.int32, device=device)
    return SlotPool(
        alive=torch.zeros(shape, dtype=torch.bool, device=device),
        age=z, hits=z.clone(), hit_streak=z.clone(),
        time_since_update=z.clone(),
        uid=torch.full(shape, -1, dtype=torch.int32, device=device),
        cls=torch.full(shape, -1, dtype=torch.int32, device=device),
        next_uid=torch.full(tuple(batch_shape), uid_start, dtype=torch.int32,
                            device=device),
    )


def transpose_pool(pool: SlotPool) -> SlotPool:
    """Move the slot axis between last (``[..., T]``) and first
    (``[T, ...]``).  An involution; ``next_uid`` has no slot axis."""
    return pool._replace(
        **{f: torch.movedim(getattr(pool, f), -1, 0).contiguous()
           for f in _SLOT_FIELDS})


def assign_slots_lane(free_mask: torch.Tensor,
                      want_mask: torch.Tensor) -> torch.Tensor:
    """Rank-match claimants to free slots: ``free [T, ...]``, ``want
    [D, ...]`` (bool) -> ``slot_for [D, ...] int32``.  The k-th claimant
    (in index order) takes the k-th free slot, or -1 when the pool is
    exhausted."""
    t = free_mask.shape[0]
    free_rank = torch.cumsum(free_mask, dim=0) - 1   # rank of each free slot
    want_rank = torch.cumsum(want_mask, dim=0) - 1   # rank of each claimant
    num_free = free_mask.sum(dim=0, keepdim=True)

    # slot_of_rank[r] = index of the r-th free slot (overflow row t)
    slot_of_rank = torch.full((t + 1,) + free_mask.shape[1:], -1,
                              dtype=torch.long, device=free_mask.device)
    scatter_to = torch.where(free_mask, free_rank, t)
    slot_idx = torch.arange(t, device=free_mask.device).reshape(
        (t,) + (1,) * (free_mask.dim() - 1)).expand(free_mask.shape)
    slot_of_rank = slot_of_rank.scatter(0, scatter_to, slot_idx)

    ok = want_mask & (want_rank < num_free)
    lookup = torch.where(ok, want_rank, t)
    slot_for = torch.gather(slot_of_rank, 0, lookup)
    return torch.where(ok, slot_for, -1).to(torch.int32)


def birth_lane(pool: SlotPool, slot_for: torch.Tensor) -> SlotPool:
    """Activate the claimed slots of a lane-major pool (``slot_for [D, ...]``
    from :func:`assign_slots_lane`).  The k-th claimant of a stream gets uid
    ``next_uid + k``; births are class 0."""
    t = pool.alive.shape[0]
    claimed = slot_for >= 0                                  # [D, ...]
    target = torch.where(claimed, slot_for, t).long()        # overflow -> t

    def scat(field, value):
        ext = torch.cat([field, field[:1]], dim=0)           # overflow row
        value = torch.as_tensor(value, dtype=field.dtype, device=field.device)
        return ext.scatter(0, target, value.expand(target.shape))[:t]

    order = torch.cumsum(claimed, dim=0) - 1
    uids = pool.next_uid[None] + torch.where(claimed, order, 0)
    n_born = claimed.sum(dim=0)
    return SlotPool(
        alive=scat(pool.alive, True),
        age=scat(pool.age, 0),
        hits=scat(pool.hits, 0),
        hit_streak=scat(pool.hit_streak, 0),
        time_since_update=scat(pool.time_since_update, 0),
        uid=scat(pool.uid, uids.to(torch.int32)),
        cls=scat(pool.cls, 0),
        next_uid=pool.next_uid + n_born.to(torch.int32),
    )


def tick(pool: SlotPool, matched: torch.Tensor, max_age: int) -> SlotPool:
    """Advance one step: matched slots refresh, unmatched ones age, and a
    slot whose ``time_since_update`` exceeds ``max_age`` dies.

    Elementwise, so it takes either orientation (``matched`` shaped like
    the slot fields).
    """
    alive = pool.alive
    hit = alive & matched
    miss = alive & ~matched
    tsu = torch.where(hit, 0, pool.time_since_update + miss.to(torch.int32))
    new_alive = alive & (tsu <= max_age)
    return pool._replace(
        alive=new_alive,
        age=torch.where(alive, pool.age + 1, pool.age),
        hits=pool.hits + hit.to(torch.int32),
        hit_streak=torch.where(hit, pool.hit_streak + 1,
                               torch.where(miss, 0, pool.hit_streak)),
        time_since_update=tsu,
        uid=torch.where(new_alive, pool.uid, -1),
        cls=torch.where(new_alive, pool.cls, -1),
    )
