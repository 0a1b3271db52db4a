"""The paper's own workload config: SORT over MOT15-shaped streams.

The presets the port runs so far, with the same values as the JAX
package's ``repro/configs/sort_mot.py``: slot capacity covers paper
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
