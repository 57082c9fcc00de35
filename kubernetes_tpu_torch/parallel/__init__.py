"""The sharded execution backend's host side (the port of
``kubernetes_tpu/parallel``): the node-axis mesh (:mod:`.mesh`, on one
card: a logical mesh whose shards share the card) and the analytic
scale-out model the perf ledger divides by (:mod:`.costmodel`)."""

from kubernetes_tpu_torch.parallel.mesh import (  # noqa: F401
    NODE_AXIS,
    Mesh,
    MeshError,
    largest_pow2,
    local_devices,
    make_mesh,
    mesh_from_spec,
    mesh_size,
    normalize_device,
    place_node_table,
    replicate,
    shard_cluster,
    shard_nodes,
    shard_usage,
    shards,
)
