"""SORT's constant-velocity Kalman filter constants, for the lane path.

State ``x = [u, v, s, r, du, dv, ds]`` (``DIM_X = 7``), observation
``z = [u, v, s, r]`` (``DIM_Z = 4``).  The lane-layout arithmetic itself
lives in :mod:`repro_torch.kernels.ref`; this module holds the numbers it
and the engine share.
"""
from __future__ import annotations

import numpy as np
import torch

DIM_X = 7
DIM_Z = 4

# diagonals of the process noise Q and the measurement noise R (Bewley's
# reference implementation), in the order the lane algebra adds them
Q_DIAG = (1.0, 1.0, 1.0, 1.0, 0.01, 0.01, 1e-4)
R_DIAG = (1.0, 1.0, 10.0, 10.0)


def initial_covariance_np() -> np.ndarray:
    """The initial covariance of a newborn tracker, ``[7, 7]`` float64."""
    p = np.eye(DIM_X) * 10.0
    p[4, 4] = p[5, 5] = p[6, 6] = 1e4  # unobserved velocities: uncertain
    return p


def initial_covariance(dtype=torch.float32, device=None) -> torch.Tensor:
    """:func:`initial_covariance_np` as a ``[7, 7]`` tensor, filled on the
    device itself: the engine builds it every frame, and a copy from host
    memory would make the host wait for the device each time."""
    p = torch.zeros((DIM_X, DIM_X), dtype=dtype, device=device)
    diag = p.diagonal()
    diag[:4] = 10.0
    diag[4:] = 1e4
    return p
