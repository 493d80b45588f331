"""The pipeline stages (reference pkg/scheduler/actions/).

Importing this package registers every built-in action with the port's
framework registry (reference actions/factory.go:29-35).
"""

from kube_batch_tpu_torch.actions.factory import register_all_actions

register_all_actions()
