"""L4 framework: session + extension-point registry
(reference pkg/scheduler/framework/)."""

from kube_batch_tpu_torch.framework.arguments import Arguments
from kube_batch_tpu_torch.framework.event import Event, EventHandler
from kube_batch_tpu_torch.framework.interface import Action, Cache, Plugin
from kube_batch_tpu_torch.framework.registry import (
    cleanup_plugin_builders,
    get_action,
    get_plugin_builder,
    register_action,
    register_plugin_builder,
)
from kube_batch_tpu_torch.framework.session import Session, close_session, open_session
from kube_batch_tpu_torch.framework.statement import Statement

__all__ = [
    "Action",
    "Arguments",
    "Cache",
    "Event",
    "EventHandler",
    "Plugin",
    "Session",
    "Statement",
    "cleanup_plugin_builders",
    "close_session",
    "get_action",
    "get_plugin_builder",
    "open_session",
    "register_action",
    "register_plugin_builder",
]
