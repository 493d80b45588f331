"""Plugin registration (reference pkg/scheduler/plugins/factory.go:31-42)."""

from __future__ import annotations

from kube_batch_tpu_torch.framework.registry import register_plugin_builder


def register_all_plugins() -> None:
    from kube_batch_tpu_torch.plugins import (
        conformance,
        drf,
        gang,
        nodeorder,
        predicates,
        priority,
        proportion,
    )

    register_plugin_builder("priority", priority.new)
    register_plugin_builder("gang", gang.new)
    register_plugin_builder("conformance", conformance.new)
    register_plugin_builder("drf", drf.new)
    register_plugin_builder("proportion", proportion.new)
    register_plugin_builder("predicates", predicates.new)
    register_plugin_builder("nodeorder", nodeorder.new)
