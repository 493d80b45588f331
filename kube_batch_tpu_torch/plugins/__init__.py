"""The policies (reference pkg/scheduler/plugins/).

Importing this package registers every built-in plugin builder with the
port's framework registry (reference plugins/factory.go:31-42 does the
same via blank imports from main.go:33-34).
"""

from kube_batch_tpu_torch.plugins.factory import register_all_plugins

register_all_plugins()
