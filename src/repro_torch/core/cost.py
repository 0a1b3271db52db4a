"""Association cost specification.

The score is ``iou_weight * IoU + embed_weight * <det_embed, trk_embed>``,
with optional hard feasibility terms (a Mahalanobis motion gate and, at
``num_classes > 1``, a class partition).  This port runs the pure-IoU,
single-class spec only; the score and feasibility evaluators come with the
multi-class slice, and :class:`repro_torch.core.sort.SortEngine` refuses
any other spec at construction.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["CHI2_GATE_4DOF", "CostSpec", "IOU", "needs_score",
           "needs_feasible"]

# 0.95 quantile of the chi-squared distribution with 4 degrees of freedom
CHI2_GATE_4DOF = 9.487729036781154


@dataclasses.dataclass(frozen=True)
class CostSpec:
    """A composable association cost: IoU ⊕ Mahalanobis gate ⊕ embedding.

    * ``iou_weight`` — weight of the IoU term in the score.
    * ``maha_gate`` — chi² threshold on the squared Mahalanobis distance
      (``None`` = no motion gate).  A *hard* feasibility mask.
    * ``embed_weight`` / ``embed_dim`` — appearance term: the dot product
      of per-detection / per-track embedding vectors of length
      ``embed_dim``, scaled by ``embed_weight``.
    """

    iou_weight: float = 1.0
    maha_gate: Optional[float] = None
    embed_weight: float = 0.0
    embed_dim: int = 0

    def __post_init__(self):
        if self.embed_weight != 0.0 and self.embed_dim <= 0:
            raise ValueError(
                f"embed_weight={self.embed_weight} needs embed_dim > 0")
        if self.embed_dim < 0:
            raise ValueError(f"embed_dim must be >= 0, got {self.embed_dim}")
        if self.maha_gate is not None and self.maha_gate <= 0.0:
            raise ValueError(f"maha_gate must be > 0, got {self.maha_gate}")

    @property
    def uses_maha(self) -> bool:
        return self.maha_gate is not None

    @property
    def uses_embed(self) -> bool:
        return self.embed_weight != 0.0 and self.embed_dim > 0

    @property
    def is_iou_only(self) -> bool:
        """True when the score is plain IoU with no extra feasibility."""
        return (self.iou_weight == 1.0 and not self.uses_maha
                and not self.uses_embed)


IOU = CostSpec()


def needs_score(cost: CostSpec) -> bool:
    """True when the solve must run on a combined score instead of IoU."""
    return cost.iou_weight != 1.0 or cost.uses_embed


def needs_feasible(cost: CostSpec, num_classes: int) -> bool:
    """True when a hard pair-feasibility mask must enter the solve."""
    return num_classes > 1 or cost.uses_maha
