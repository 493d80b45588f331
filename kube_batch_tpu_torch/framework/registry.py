"""Global plugin-builder and action registries
(reference pkg/scheduler/framework/plugins.go:30-72)."""

from __future__ import annotations

import threading
from typing import Callable, Optional

from kube_batch_tpu_torch.framework.arguments import Arguments
from kube_batch_tpu_torch.framework.interface import Action, Plugin

PluginBuilder = Callable[[Arguments], Plugin]

_mutex = threading.Lock()
_plugin_builders: dict[str, PluginBuilder] = {}
_actions: dict[str, Action] = {}


def register_plugin_builder(name: str, builder: PluginBuilder) -> None:
    with _mutex:
        _plugin_builders[name] = builder


def get_plugin_builder(name: str) -> Optional[PluginBuilder]:
    with _mutex:
        return _plugin_builders.get(name)


def cleanup_plugin_builders() -> None:
    with _mutex:
        _plugin_builders.clear()


def register_action(action: Action) -> None:
    with _mutex:
        _actions[action.name] = action


def get_action(name: str) -> Optional[Action]:
    with _mutex:
        return _actions.get(name)
