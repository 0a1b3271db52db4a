"""The paper's own workload config: SORT over MOT15-shaped streams.

The presets the port runs so far, with the same values as the JAX
package's ``repro/configs/sort_mot.py`` (the megakernel presets: the
repository's ``configs/sort_mot.py:41-46``): slot capacity covers paper
Table I's maximum of 13 simultaneous objects with headroom, and the lane
budget per device is ``streams_per_chip``."""
import dataclasses

from repro_torch.core.sort import SortConfig


@dataclasses.dataclass(frozen=True)
class SortServiceConfig:
    sort: SortConfig
    streams_per_chip: int = 2048     # lane batch per device


# Lane-resident fused serving path, paper-exact: one kernel launch per
# frame, fed by the lane-batched Hungarian stage.
FUSED = SortServiceConfig(
    sort=SortConfig(max_trackers=16, max_detections=16, iou_threshold=0.3,
                    max_age=1, min_hits=3, assoc="hungarian",
                    use_kernels=True))

# The FUSED engine behind the crash-exact tracking service (the service
# front-end itself is a later slice of the port).
SERVICE = SortServiceConfig(
    sort=SortConfig(max_trackers=16, max_detections=16, iou_threshold=0.3,
                    max_age=1, min_hits=3, assoc="hungarian",
                    use_kernels=True))

# Chunk-resident serving: one kernel launch per serving chunk, with the
# lifecycle and the Hungarian solve inside the launch (the repository's
# configs/sort_mot.py:41-42).
MEGAKERNEL = SortServiceConfig(
    sort=SortConfig(max_trackers=16, max_detections=16, use_kernels=True,
                    chunk_kernel=True))

# The same with greedy association in the kernel (configs/sort_mot.py:
# 44-46).
MEGAKERNEL_GREEDY = SortServiceConfig(
    sort=SortConfig(max_trackers=16, max_detections=16, use_kernels=True,
                    chunk_kernel=True, assoc="greedy"))
