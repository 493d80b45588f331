"""PyTorch/CUDA port of kube_batch_tpu's scheduling core.

Imports torch and numpy only, never jax or the kube_batch_tpu package.
The entry point is the scheduling cycle,
``kube_batch_tpu_torch.scheduler.Scheduler(cache, conf).run_once()``;
``kube_batch_tpu_torch.solve.allocate`` is the lower one, with no session.
"""
