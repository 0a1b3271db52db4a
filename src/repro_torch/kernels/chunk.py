"""The chunk-resident SORT kernel: one launch per F-frame serving chunk.

:func:`fused_chunk` wraps ``csrc/chunk.cu`` (CUDA C++ for Hopper), the port
of the JAX package's Pallas kernel ``kernels/chunk.py::fused_chunk``.  One
launch runs F whole serving steps for every stream: masked lane re-init,
predict, association, masked update, tick, births, inactive-lane freeze
and emit, with the state held on chip across the frame loop.  The
association is greedy, the Hungarian (JV) solve of each stream's
assignment, or a gather by a precomputed ``trk_to_det [F, T, S]`` (the
TPU kernel's own interface), all inside the launch.

Given CPU tensors it runs the plain version, :func:`ref.chunk_lane`; given
CUDA tensors it launches the kernel or raises.  ``fused_chunk.launches``
counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref
from .frame import MAX_D, MAX_T, _check

_P = ctypes.c_void_p
_ASSOC = {"greedy": 0, "hungarian": 1}     # csrc/chunk.cu: Assoc
_GATHER = 2
_STATE_INT = ("alive", "age", "hits", "hit_streak", "time_since_update",
              "uid", "cls")


class _Args(ctypes.Structure):
    """Mirror of ``ChunkArgs`` in ``csrc/chunk.cu``."""

    _fields_ = ([(f"in_{n}", _P) for n in ("x", "p", *_STATE_INT,
                                           "next_uid", "frame_count")]
                + [(n, _P) for n in ("det", "det_mask", "active", "reset",
                                     "t2d_in")]
                + [(f"out_{n}", _P) for n in ("x", "p", *_STATE_INT,
                                              "next_uid", "frame_count")]
                + [(n, _P) for n in ("boxes", "uid", "emit", "t2d",
                                     "matched", "cls")]
                + [(n, ctypes.c_int) for n in ("F", "T", "D", "S", "assoc",
                                               "max_age", "min_hits")]
                + [("iou_threshold", ctypes.c_float)])


def _library() -> ctypes.CDLL:
    lib = build.load("chunk")
    fn = lib.fused_chunk_launch
    fn.argtypes = [ctypes.POINTER(_Args), _P]
    fn.restype = ctypes.c_int
    return lib


def fused_chunk(state: ref.ChunkState, det, det_mask, active, reset,
                trk_to_det=None, *, iou_threshold: float = 0.3,
                max_age: int = 1, min_hits: int = 3,
                assoc: str = "greedy"):
    """F serving steps for every stream in one launch.

    ``state`` is a :class:`ref.ChunkState` (float32 ``x``/``p``, int32
    lifecycle, ``embed [0, T, S]``); ``det [F, D, 4, S]`` xyxy,
    ``det_mask [F, D, S]`` and ``active [F, 1, S]`` 0/1 float32, ``reset
    [F, 1, S]`` 0/1 int32.  ``trk_to_det [F, T, S] int32`` (optional) is a
    precomputed, gated assignment: the kernel then gathers by it instead of
    associating (``assoc`` is ignored).

    Returns ``(ChunkState, ChunkOuts)`` stacked over F, ``emit`` and
    ``matched_det`` as int32 0/1.
    """
    if assoc not in _ASSOC:
        raise ValueError(f"unknown assoc {assoc!r}")
    dev = state.x.device
    if dev.type == "cpu":
        st, outs = ref.chunk_lane(
            state, det, det_mask, active, reset, trk_to_det,
            iou_threshold=iou_threshold, max_age=max_age, min_hits=min_hits,
            assoc=assoc)
        return st, outs._replace(emit=outs.emit.to(torch.int32),
                                 matched_det=outs.matched_det.to(torch.int32))
    if dev.type != "cuda":
        raise ValueError(f"fused_chunk runs on CPU or CUDA tensors, got "
                         f"{dev}")
    t, s = state.alive.shape
    f, d = det.shape[0], det.shape[1]
    if not (1 <= t <= MAX_T and 0 <= d <= MAX_D):
        raise ValueError(f"the kernel takes 1 <= T <= {MAX_T} and "
                         f"0 <= D <= {MAX_D}, got T={t}, D={d}")
    f32, i32 = torch.float32, torch.int32
    _check("x", state.x, f32, (7, t, s), dev)
    _check("p", state.p, f32, (49, t, s), dev)
    for name in _STATE_INT:
        _check(name, getattr(state, name), i32, (t, s), dev)
    _check("next_uid", state.next_uid, i32, (1, s), dev)
    _check("frame_count", state.frame_count, i32, (1, s), dev)
    if state.embed.shape != (0, t, s):
        raise ValueError("the kernel carries no appearance embedding: "
                         f"embed must be (0, {t}, {s}), got "
                         f"{tuple(state.embed.shape)}")
    _check("det", det, f32, (f, d, 4, s), dev)
    _check("det_mask", det_mask, f32, (f, d, s), dev)
    _check("active", active, f32, (f, 1, s), dev)
    _check("reset", reset, i32, (f, 1, s), dev)
    if trk_to_det is not None:
        _check("trk_to_det", trk_to_det, i32, (f, t, s), dev)

    new = ref.ChunkState(*(torch.empty_like(v) for v in state[:-1]),
                         embed=state.embed)
    outs = ref.ChunkOuts(
        boxes=torch.empty((f, t, 4, s), dtype=f32, device=dev),
        uid=torch.empty((f, t, s), dtype=i32, device=dev),
        emit=torch.empty((f, t, s), dtype=i32, device=dev),
        trk_to_det=torch.empty((f, t, s), dtype=i32, device=dev),
        matched_det=torch.empty((f, d, s), dtype=i32, device=dev),
        cls=torch.empty((f, t, s), dtype=i32, device=dev))
    if s == 0 or f == 0:
        return state, outs

    def ptr(a):
        return None if a is None else a.data_ptr()

    leaves = ("x", "p", *_STATE_INT, "next_uid", "frame_count")
    args = _Args(
        **{f"in_{n}": ptr(getattr(state, n)) for n in leaves},
        det=ptr(det), det_mask=ptr(det_mask), active=ptr(active),
        reset=ptr(reset), t2d_in=ptr(trk_to_det),
        **{f"out_{n}": ptr(getattr(new, n)) for n in leaves},
        boxes=ptr(outs.boxes), uid=ptr(outs.uid), emit=ptr(outs.emit),
        t2d=ptr(outs.trk_to_det), matched=ptr(outs.matched_det),
        cls=ptr(outs.cls), F=f, T=t, D=d, S=s,
        assoc=_GATHER if trk_to_det is not None else _ASSOC[assoc],
        max_age=max_age, min_hits=min_hits, iou_threshold=iou_threshold)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.fused_chunk_launch(
            ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_chunk kernel launch failed: CUDA error "
                           f"{err}")
    fused_chunk.launches += 1
    return new, outs


fused_chunk.launches = 0
