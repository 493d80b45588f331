"""PyTorch/CUDA port of kube_batch_tpu's scheduling core.

Imports torch and numpy only, never jax or the kube_batch_tpu package.
The entry point is ``kube_batch_tpu_torch.solve.allocate``.
"""
