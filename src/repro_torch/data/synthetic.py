"""Synthetic MOT workload generator.

Produces ground-truth multi-object trajectories plus noisy detections with
false positives and dropouts — statistically shaped like the MOT15 sequences
in paper Table I (≤13 simultaneous objects, hundreds of frames), so the
benchmarks can sweep stream counts far beyond the paper's 11 files.

Pure numpy on the host (this is the data pipeline, not the tracker); a
copy of the JAX package's generator, so both packages draw the same scenes
from the same seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    num_frames: int = 200
    max_objects: int = 12           # simultaneous objects (Table I max: 13)
    img_w: float = 1920.0
    img_h: float = 1080.0
    mean_size: float = 80.0         # mean box side, px
    speed: float = 8.0              # px/frame
    birth_rate: float = 0.05        # P(new object appears per frame)
    death_rate: float = 0.005       # P(object leaves per frame)
    det_noise: float = 2.0          # detection jitter, px
    miss_rate: float = 0.05         # P(detection dropout)
    fp_rate: float = 0.1            # expected false positives per frame
    seed: int = 0


def generate_scene(cfg: SceneConfig):
    """Simulate one video sequence.

    Returns
    -------
    gt_boxes : float32 ``[F, K, 4]`` xyxy ground truth (K = total objects ever)
    gt_mask  : bool    ``[F, K]`` object present in frame
    det_boxes: float32 ``[F, D, 4]`` noisy detections (padded)
    det_mask : bool    ``[F, D]``
    """
    rng = np.random.default_rng(cfg.seed)
    f = cfg.num_frames

    # --- simulate object lifecycles ---
    tracks = []  # (t_birth, t_death, trajectory [L, 4])
    active = []
    for _ in range(rng.integers(2, max(3, cfg.max_objects // 2 + 1))):
        active.append(_spawn(rng, cfg, 0))
    for t in range(1, f):
        if len(active) < cfg.max_objects and rng.random() < cfg.birth_rate:
            active.append(_spawn(rng, cfg, t))
        survivors = []
        for tr in active:
            if rng.random() < cfg.death_rate:
                tr["t_death"] = t
                tracks.append(tr)
            else:
                _step(tr, cfg)
                survivors.append(tr)
        active = survivors
    for tr in active:
        tr["t_death"] = f
        tracks.append(tr)

    k = len(tracks)
    gt_boxes = np.zeros((f, k, 4), np.float32)
    gt_mask = np.zeros((f, k), bool)
    for i, tr in enumerate(tracks):
        t0, t1 = tr["t_birth"], tr["t_death"]
        traj = np.asarray(tr["traj"][: t1 - t0], np.float32).reshape(-1, 4)
        gt_boxes[t0:t0 + len(traj), i] = traj
        gt_mask[t0:t0 + len(traj), i] = True

    # --- corrupt into detections ---
    d_max = cfg.max_objects + max(2, int(3 * cfg.fp_rate))
    det_boxes = np.zeros((f, d_max, 4), np.float32)
    det_mask = np.zeros((f, d_max), bool)
    for t in range(f):
        dets = []
        for i in range(k):
            if gt_mask[t, i] and rng.random() >= cfg.miss_rate:
                dets.append(gt_boxes[t, i] + rng.normal(0, cfg.det_noise, 4))
        n_fp = rng.poisson(cfg.fp_rate)
        for _ in range(n_fp):
            cx = rng.uniform(0, cfg.img_w)
            cy = rng.uniform(0, cfg.img_h)
            s = rng.uniform(0.5, 1.5) * cfg.mean_size
            dets.append([cx - s / 2, cy - s / 2, cx + s / 2, cy + s / 2])
        rng.shuffle(dets)
        dets = dets[:d_max]
        if dets:
            det_boxes[t, : len(dets)] = np.asarray(dets, np.float32)
            det_mask[t, : len(dets)] = True
    return gt_boxes, gt_mask, det_boxes, det_mask


def _spawn(rng, cfg, t):
    w = max(8.0, rng.normal(cfg.mean_size, cfg.mean_size / 4))
    # pedestrian-ish: about twice as tall as wide
    h = max(8.0, rng.normal(cfg.mean_size * 2, cfg.mean_size / 3))
    cx = rng.uniform(w, cfg.img_w - w)
    cy = rng.uniform(h, cfg.img_h - h)
    vx, vy = rng.normal(0, cfg.speed, 2)
    box = [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]
    return {"t_birth": t, "t_death": None, "traj": [box],
            "v": (vx, vy), "wh": (w, h), "c": (cx, cy)}


def _step(tr, cfg):
    vx, vy = tr["v"]
    cx, cy = tr["c"]
    w, h = tr["wh"]
    cx = float(np.clip(cx + vx, w / 2, cfg.img_w - w / 2))
    cy = float(np.clip(cy + vy, h / 2, cfg.img_h - h / 2))
    tr["c"] = (cx, cy)
    tr["traj"].append([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])
