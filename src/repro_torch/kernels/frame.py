"""The fused whole-frame SORT kernel: one launch per frame.

:func:`fused_frame` wraps ``csrc/frame.cu`` (CUDA C++ for Hopper), the port
of the JAX package's Pallas kernel ``kernels/frame.py::fused_frame``.  It
runs predict -> association -> masked update -> inactive-lane restore for
every stream.  The association is either greedy inside the kernel or a
gather by a precomputed ``trk_to_det`` (the Hungarian path, whose solve
runs before the launch).

Given CPU tensors it runs the plain version, :func:`ref.frame_lane`; given
CUDA tensors it launches the kernel or raises.  ``fused_frame.launches``
counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

MAX_T = 32      # the kernel's bounds on tracker slots and detections
MAX_D = 32      # per stream (csrc/frame.cu: kMaxT, kMaxD)

_P = ctypes.c_void_p
_I = ctypes.c_int


def _library() -> ctypes.CDLL:
    lib = build.load("frame")
    fn = lib.fused_frame_launch
    fn.argtypes = [_P] * 11 + [_I, _I, _I, ctypes.c_float, _P]
    fn.restype = _I
    return lib


def _check(name, a, dtype, shape, device):
    if a.device != device:
        raise ValueError(f"{name} is on {a.device}, x on {device}")
    if a.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {a.dtype}")
    if tuple(a.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(a.shape)}")
    if not a.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_frame(x, p, det, det_mask, alive, stream_active=None,
                trk_to_det=None, *, iou_threshold: float = 0.3):
    """One SORT frame for every stream in one launch.

    ``x [7, T, S]``, ``p [49, T, S]``, ``det [D, 4, S]`` xyxy,
    ``det_mask [D, S]`` and ``alive [T, S]`` 0/1 float32;
    ``stream_active [1, S]`` 0/1 float32 (optional) makes the lanes with 0
    exact no-ops.  ``trk_to_det [T, S] int32`` (optional) is a precomputed,
    already gated assignment: the kernel then skips its IoU and greedy
    phases and gathers each tracker's detection by it.

    Returns ``(x, p, trk_to_det [T, S] int32, matched_det [D, S] int32)``.
    """
    if x.device.type == "cpu":
        x, p, t2d, md = ref.frame_lane(
            x, p, det, det_mask, alive, iou_threshold, active=stream_active,
            assoc="greedy", trk_to_det=trk_to_det)
        return x, p, t2d, md.to(torch.int32)
    if x.device.type != "cuda":
        raise ValueError(f"fused_frame runs on CPU or CUDA tensors, got "
                         f"{x.device}")
    t, s = x.shape[1], x.shape[2]
    d = det.shape[0]
    if not (1 <= t <= MAX_T and 0 <= d <= MAX_D):
        raise ValueError(f"the kernel takes 1 <= T <= {MAX_T} and "
                         f"0 <= D <= {MAX_D}, got T={t}, D={d}")
    dev, f32 = x.device, torch.float32
    _check("x", x, f32, (7, t, s), dev)
    _check("p", p, f32, (49, t, s), dev)
    _check("det", det, f32, (d, 4, s), dev)
    _check("det_mask", det_mask, f32, (d, s), dev)
    _check("alive", alive, f32, (t, s), dev)
    if stream_active is not None:
        _check("stream_active", stream_active, f32, (1, s), dev)
    if trk_to_det is not None:
        _check("trk_to_det", trk_to_det, torch.int32, (t, s), dev)
    x_out = torch.empty_like(x)
    p_out = torch.empty_like(p)
    t2d = torch.empty((t, s), dtype=torch.int32, device=dev)
    md = torch.empty((d, s), dtype=torch.int32, device=dev)
    if s == 0:
        return x_out, p_out, t2d, md

    def ptr(a):
        return None if a is None else a.data_ptr()

    lib = _library()
    with torch.cuda.device(dev):
        err = lib.fused_frame_launch(
            ptr(x), ptr(p), ptr(det), ptr(det_mask), ptr(alive),
            ptr(stream_active), ptr(trk_to_det), ptr(x_out), ptr(p_out),
            ptr(t2d), ptr(md), t, d, s, iou_threshold,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_frame kernel launch failed: CUDA error "
                           f"{err}")
    fused_frame.launches += 1
    return x_out, p_out, t2d, md


fused_frame.launches = 0
