"""Placement of partitioned state over processes and cards. Counterpart of
``repro.dist``; only the vertex-partition half (:func:`sharding.shard_mesh`)
is ported."""

from repro_torch.dist.sharding import ShardMesh, shard_mesh

__all__ = ["ShardMesh", "shard_mesh"]
