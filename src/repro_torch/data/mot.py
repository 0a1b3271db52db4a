"""MOT15 challenge sizes and result format (paper Table I datasets).

``write_results`` emits the MOT15 submission format the original SORT
writes, so outputs are directly comparable.
"""
from __future__ import annotations

import numpy as np

# Paper Table I: the 11 MOT15 train sequences and their sizes, used by the
# synthetic workload generator to mimic real stream statistics.
TABLE_I = {
    "PETS09-S2L1": (795, 8),
    "TUD-Campus": (71, 6),
    "TUD-Stadtmitte": (179, 7),
    "ETH-Bahnhof": (1000, 9),
    "ETH-Sunnyday": (354, 8),
    "ETH-Pedcross2": (837, 9),
    "KITTI-13": (340, 5),
    "KITTI-17": (145, 7),
    "ADL-Rundle-6": (525, 11),
    "ADL-Rundle-8": (654, 11),
    "Venice-2": (600, 13),
}


def write_results(path, boxes, uids, emit):
    """Write tracking output in MOT15 submission format.

    ``boxes [F, T, 4]`` xyxy, ``uids [F, T]``, ``emit [F, T]`` bool.
    """
    with open(path, "w") as fh:
        for t in range(boxes.shape[0]):
            for k in np.where(emit[t])[0]:
                x1, y1, x2, y2 = boxes[t, k]
                fh.write(f"{t + 1},{int(uids[t, k])},{x1:.2f},{y1:.2f},"
                         f"{x2 - x1:.2f},{y2 - y1:.2f},1,-1,-1,-1\n")
