"""kbt-ctl — the queue admin CLI (reference cmd/cli/queue.go +
pkg/cli/queue/{create,list}.go).

The reference CLI talks to the Kubernetes API server with a generated
clientset; here the scheduler server's HTTP queue API
(kube_batch_tpu_torch/server.py) is the backend:

    python -m kube_batch_tpu_torch.cli queue create --name q1 --weight 3
    python -m kube_batch_tpu_torch.cli queue list [--watch]
    python -m kube_batch_tpu_torch.cli queue delete --name q1
    python -m kube_batch_tpu_torch.cli version
    python -m kube_batch_tpu_torch.cli explain [--gang ns/name] [--json]

`--server` points at the scheduler's listen address (the reference's
--master/--kubeconfig pair collapses to one URL with no auth layer).
``explain`` reads the server's /debug/explain forensics (``KBT_EXPLAIN``).
"""

from kube_batch_tpu_torch.cli.queue import main

__all__ = ["main"]
