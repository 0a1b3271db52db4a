"""Carry state and config across from the JAX package.

This system has no weights: a tracker's state and its config play that
part.  The JAX package's ``LaneSortState`` crosses as a flat dict of numpy
arrays — ``x``, ``p``, the ``SlotPool`` fields, ``frame_count``,
``embed`` — and so does its chunk kernel's ``ChunkState``, so the two
packages can start from the same mid-sequence state.  Nothing here imports the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import cost as cost_mod
from .core import slots
from .core.sort import LaneSortState, SortConfig
from .kernels.ref import ChunkState

_POOL_DTYPES = {"alive": torch.bool, "age": torch.int32,
                "hits": torch.int32, "hit_streak": torch.int32,
                "time_since_update": torch.int32, "uid": torch.int32,
                "cls": torch.int32, "next_uid": torch.int32}


def lane_state_from_numpy(fields: dict, device=None) -> LaneSortState:
    """A lane-layout state from numpy leaves: ``x [7, B]``, ``p [49, B]``,
    the slot fields ``[T, S]``, ``next_uid [S]``, ``frame_count [S]`` and
    ``embed [E, B]`` (``B = T * S``, slot-major).  The reference pads
    streams only on a TPU, so a state taken from it elsewhere has
    ``S`` real streams."""
    missing = ({"x", "p", "frame_count", "embed"} | set(_POOL_DTYPES)) \
        - set(fields)
    if missing:
        raise ValueError(f"lane state is missing {sorted(missing)}")

    def tensor(name, dtype):
        return torch.tensor(np.asarray(fields[name]), dtype=dtype,
                            device=device)

    x = tensor("x", torch.float32)
    pool = slots.SlotPool(**{f: tensor(f, dt)
                             for f, dt in _POOL_DTYPES.items()})
    t, s = pool.alive.shape
    if x.shape != (7, t * s):
        raise ValueError(f"x has shape {tuple(x.shape)}, the pool "
                         f"{t}x{s} needs (7, {t * s})")
    return LaneSortState(x=x, p=tensor("p", x.dtype), pool=pool,
                         frame_count=tensor("frame_count", torch.int32),
                         embed=tensor("embed", x.dtype))


def lane_state_to_numpy(lane: LaneSortState) -> dict:
    """The inverse of :func:`lane_state_from_numpy`."""
    out = {"x": lane.x, "p": lane.p, "frame_count": lane.frame_count,
           "embed": lane.embed, **lane.pool._asdict()}
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def chunk_state_from_numpy(fields: dict, device=None) -> ChunkState:
    """A chunk-kernel state from the reference's ``ChunkState`` leaves as
    numpy arrays (``x [7, T, S]``, ``p [49, T, S]`` float32; the int32 slot
    fields ``[T, S]``; ``next_uid``/``frame_count [1, S]``; ``embed
    [E, T, S]``), keyed by field name."""
    missing = set(ChunkState._fields) - set(fields)
    if missing:
        raise ValueError(f"chunk state is missing {sorted(missing)}")
    leaves = {}
    for name in ChunkState._fields:
        dtype = (torch.float32 if name in ("x", "p", "embed")
                 else torch.int32)
        leaves[name] = torch.tensor(np.asarray(fields[name]), dtype=dtype,
                                    device=device)
    t, s = leaves["alive"].shape
    if leaves["x"].shape != (7, t, s) or leaves["p"].shape != (49, t, s):
        raise ValueError(f"x {tuple(leaves['x'].shape)} / p "
                         f"{tuple(leaves['p'].shape)} do not match the "
                         f"{t}x{s} slot fields")
    return ChunkState(**leaves)


def chunk_state_to_numpy(cs: ChunkState) -> dict:
    """The inverse of :func:`chunk_state_from_numpy`."""
    return {k: v.detach().cpu().numpy() for k, v in cs._asdict().items()}


def sort_config_from_dict(fields: dict) -> SortConfig:
    """The port's :class:`SortConfig` from the reference's fields (as
    ``dataclasses.asdict`` gives them: the cost spec as a nested dict)."""
    known = {f.name for f in dataclasses.fields(SortConfig)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"unknown SortConfig fields {sorted(unknown)}")
    kw = dict(fields)
    if isinstance(kw.get("cost"), dict):
        kw["cost"] = cost_mod.CostSpec(**kw["cost"])
    return SortConfig(**kw)
