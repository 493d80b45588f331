"""Action registration (reference pkg/scheduler/actions/factory.go:29-35)."""

from __future__ import annotations

from kube_batch_tpu_torch.framework.registry import register_action


def register_all_actions() -> None:
    from kube_batch_tpu_torch.actions import (
        allocate,
        backfill,
        enqueue,
        preempt,
        reclaim,
        torch_allocate,
        torch_backfill,
        torch_preempt,
        torch_reclaim,
    )

    register_action(enqueue.new())
    register_action(allocate.new())
    register_action(backfill.new())
    register_action(preempt.new())
    register_action(reclaim.new())
    register_action(torch_allocate.new())
    register_action(torch_backfill.new())
    register_action(torch_reclaim.new())
    register_action(torch_preempt.new())
