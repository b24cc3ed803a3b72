"""Distribution layer: the named mesh, the path-keyed sharding rules and
the vertex-partition placement, on ``torch.distributed``. Counterpart of
``repro.dist`` (whose ``compat`` shims of the JAX mesh API need no port).

``repro_torch.dist.sharding`` is the only module that names mesh axes for
data parallelism; everything else tags dimensions with its logical axes
(``ALL``, ``BATCH``) or asks it for param/batch shardings by family.
"""

from repro_torch.dist import sharding
from repro_torch.dist.sharding import Mesh, NamedSharding, PartitionSpec, ShardMesh, shard_mesh

__all__ = ["Mesh", "NamedSharding", "PartitionSpec", "ShardMesh", "shard_mesh", "sharding"]
