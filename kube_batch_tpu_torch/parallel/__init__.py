"""Node-axis sharding of the allocate solve over a mesh of devices."""

from kube_batch_tpu_torch.parallel.sharded import AXIS_NAME, NODE_AXIS_ARRAYS, make_mesh, node_blocks
from kube_batch_tpu_torch.parallel.sharded_block import ShardedBlockSolver

__all__ = ["AXIS_NAME", "NODE_AXIS_ARRAYS", "ShardedBlockSolver", "make_mesh", "node_blocks"]
