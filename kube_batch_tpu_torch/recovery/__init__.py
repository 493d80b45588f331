"""Cycle recovery: the deadline budget of one scheduling cycle."""

from kube_batch_tpu_torch.recovery.budget import CycleBudget, CycleDeadlineExceeded

__all__ = ["CycleBudget", "CycleDeadlineExceeded"]
