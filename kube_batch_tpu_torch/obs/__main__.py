"""``python -m kube_batch_tpu_torch.obs [--device cpu]``: the tracing
smoke (see obs.main)."""

from kube_batch_tpu_torch.obs import main

raise SystemExit(main())
