"""Action registration (reference pkg/scheduler/actions/factory.go:29-35)."""

from __future__ import annotations

from kube_batch_tpu_torch.framework.registry import register_action


def register_all_actions() -> None:
    from kube_batch_tpu_torch.actions import allocate, backfill, torch_allocate

    register_action(allocate.new())
    register_action(backfill.new())
    register_action(torch_allocate.new())
