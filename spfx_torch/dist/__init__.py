"""Multi-device engines over torch.distributed, one process per device:
the mesh and process group (``mesh``), the batch-sharded Cholesky and LU
(``factorize``) and the subtree-decomposed ones (``subtree``)."""

from spfx_torch.dist.factorize import ShardedCholesky, ShardedLU
from spfx_torch.dist.mesh import (init_distributed, make_mesh, replicated,
                                  round_up, shard_rows)
from spfx_torch.dist.subtree import (SubtreeCholesky, SubtreeLU,
                                     assign_owners, sn_parent)

__all__ = ["init_distributed", "make_mesh", "shard_rows", "replicated",
           "round_up", "ShardedCholesky", "ShardedLU", "SubtreeCholesky",
           "SubtreeLU", "sn_parent", "assign_owners"]
