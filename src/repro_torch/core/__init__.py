"""Batched SORT: Kalman constants, slot pools, association, the engine."""
