"""The sharded execution backend's host side (the port of
``kubernetes_tpu/parallel``): the node-axis mesh (:mod:`.mesh`: distinct
cards, or one card repeated as a logical mesh), the cross-shard
reductions of the partitioned solve (:mod:`.collectives`) and the
analytic scale-out model the perf ledger divides by (:mod:`.costmodel`)."""

from kubernetes_tpu_torch.parallel.mesh import (  # noqa: F401
    NODE_AXIS,
    Blocks,
    Mesh,
    MeshError,
    Replicated,
    ShardedNodes,
    largest_pow2,
    local_devices,
    make_mesh,
    mesh_from_spec,
    mesh_size,
    normalize_device,
    place_node_table,
    replicas,
    replicate,
    shard_cluster,
    shard_nodes,
    shard_usage,
    shards,
)
