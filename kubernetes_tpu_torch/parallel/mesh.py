"""The node-axis device mesh (the port of ``kubernetes_tpu/parallel/mesh.py``).

The reference shards the node axis of every (pods x nodes) table across a
1-D ``jax.sharding.Mesh`` and lets XLA's partitioner insert the
cross-device reductions; pods and selector tables are replicated. The
port keeps that layout and its vocabulary on one card:

- a :class:`Mesh` is a tuple of devices with the one axis
  :data:`NODE_AXIS`;
- a node-axis tensor on a mesh of ``d`` devices is held as ``d``
  contiguous row blocks of ``N / d`` rows, block ``i`` on
  ``devices[i]`` (:func:`shards`);
- every mesh device may be the same device (a *logical* mesh): the
  blocks are then views of one tensor, and the dense solve runs on it
  unchanged, as the reference's partitioner is the identity on one
  device, with the same round-loop graphs as without a mesh. The shard
  count still reaches the candidate pick of the sparse routes
  (``num_shards``), whose per-shard top-C is bit-identical to the
  reference's at the same count; the node bucket pads up to the mesh
  size (:func:`place_node_table`).

The placement helpers (:func:`shard_nodes`, :func:`replicate`,
:func:`shard_usage`, :func:`shard_cluster`) keep the reference's
vocabulary and its checks (a node axis that does not divide across the
mesh is refused). On a logical mesh they move nothing, so only
:func:`place_node_table` (the padding and that check) is on the
scheduler's path; the rest are the seam a mesh over several cards will
fill (ROADMAP A.17.2).

A mesh over distinct devices would need explicit cross-card reductions
(the fused pair's row maxima, the Sinkhorn u pass's log-sum-exp), which
are not built: :func:`make_mesh` refuses one, naming ROADMAP A.17.2,
rather than gather it onto one card.

``local_devices`` is what ``"auto"`` and a device count resolve against:
the CUDA devices, or the CPU when the scheduler runs on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import torch

from kubernetes_tpu_torch.utils import klog

NODE_AXIS = "nodes"


class MeshError(ValueError):
    """A mesh the port cannot run: one over distinct devices."""


@dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh whose one axis (:data:`NODE_AXIS`) shards nodes."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (NODE_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The device every shard lives on (a logical mesh has one)."""
        return self.devices[0]


def normalize_device(dev) -> torch.device:
    """``dev`` with a CUDA device's index made explicit."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def local_devices(kind: str = "cuda") -> list:
    """The devices a mesh spec resolves against: every CUDA device, or the
    one CPU device for ``kind == "cpu"``."""
    if kind == "cpu":
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def largest_pow2(n: int) -> int:
    """Largest power of two <= n (n >= 1)."""
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over all (or the given) devices; the single axis shards
    nodes. The node axis is padded to power-of-two buckets, and only a
    power of two divides every bucket: a non-power-of-two device count
    keeps its largest power-of-two prefix, with a warning. Repeating one
    device makes a logical mesh; distinct devices raise
    :class:`MeshError`."""
    devices = list(devices) if devices is not None else local_devices()
    if not devices:
        raise ValueError("make_mesh: no devices")
    keep = largest_pow2(len(devices))
    if keep != len(devices):
        klog.warning(
            "mesh: %d devices cannot divide the power-of-two node "
            "buckets; using the first %d (a power-of-two subset)",
            len(devices), keep)
        devices = devices[:keep]
    devices = tuple(normalize_device(d) for d in devices)
    if len(set(devices)) > 1:
        raise MeshError(
            f"mesh over distinct devices {[str(d) for d in devices]}: "
            "sharding the node axis across cards needs cross-card "
            "reductions the port does not have (ROADMAP A.17.2); use a "
            "mesh of one card")
    return Mesh(devices)


def mesh_from_spec(spec: Union[str, int, None],
                   devices: Optional[Sequence] = None) -> Optional[Mesh]:
    """Resolve the ``parallel.mesh`` config spec into a Mesh (or None).

    - ``"off"`` / ``None`` / ``0`` -> None (single-device mode);
    - ``"auto"`` -> a mesh over every local device;
    - an int ``N`` -> a mesh over the first N local devices; more than
      available clamps with a warning, a non-power-of-two falls back.

    Only real devices count: ``parallel.mesh: 8`` on one card is a mesh
    of 1, as on the reference's one-chip host."""
    if spec is None or spec == "off" or spec == 0 or spec is False:
        return None
    if spec == "auto":
        return make_mesh(devices)
    n = int(spec)
    if n < 1:
        raise ValueError(f"parallel.mesh: invalid device count {spec!r}")
    avail = list(devices) if devices is not None else local_devices()
    if n > len(avail):
        klog.warning("mesh: %d devices requested, %d available; using %d",
                     n, len(avail), len(avail))
        n = len(avail)
    return make_mesh(avail[:n])


def mesh_size(mesh: Optional[Mesh]) -> int:
    """Device count of a mesh; 0 for None (the single-device mode)."""
    return mesh.size if mesh is not None else 0


def shards(t: torch.Tensor, mesh: Mesh) -> Tuple[torch.Tensor, ...]:
    """The row blocks of a node-axis tensor: block ``i`` is rows
    ``[i * N/d, (i+1) * N/d)``, held on ``mesh.devices[i]`` (views of
    ``t`` on a logical mesh)."""
    return tuple(t.chunk(mesh.size, 0))


def _place(t: Optional[torch.Tensor], mesh: Mesh):
    return t if t is None or t.device == mesh.device else t.to(mesh.device)


def shard_nodes(nodes, mesh: Mesh):
    """Place a ``DeviceNodes`` on the mesh: node-axis tensors split into
    the mesh's row blocks, universe-shaped ones (``zone_valid``)
    replicated. The node axis must divide across the mesh (callers pad
    the bucket up to the mesh size; both are powers of two)."""
    n = nodes.allocatable.shape[0]
    if n % max(mesh.size, 1):
        raise ValueError(
            f"shard_nodes: node axis {n} not divisible by {mesh.size} mesh "
            f"devices — pad the node bucket to at least {mesh.size} rows")
    return type(nodes)(*[_place(f, mesh) for f in nodes])


def place_node_table(table, mesh: Mesh, pad_to: Optional[int] = None):
    """Host ``NodeTable`` -> mesh-placed ``DeviceNodes`` in one call: pad
    the node bucket up to the mesh size, upload, shard along N. The one
    placement seam of the cache's full rebuild, the host-mode cycle and
    the warmup."""
    from kubernetes_tpu_torch.ops.arrays import nodes_to_device
    from kubernetes_tpu_torch.utils.interner import bucket_size

    n_pad = pad_to or bucket_size(max(table.n, 1))
    n_pad = max(n_pad, mesh.size)
    return shard_nodes(nodes_to_device(table, pad_to=n_pad,
                                       device=mesh.device), mesh)


def shard_usage(u, mesh: Mesh):
    """Shard a node-axis usage table (``ops/assign.UsageState``, every
    field (N, ...)) along the mesh, as the resident table is."""
    return type(u)(*[_place(f, mesh) for f in u])


def replicate(tree, mesh: Mesh):
    """Replicate a table (pods, selectors, topology) across the mesh."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return _place(tree, mesh)
    out = [replicate(f, mesh) for f in tree]
    return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)


def shard_cluster(pods, nodes, sel, mesh: Mesh, topo=None):
    """One-call placement of a cycle's inputs: pods, selectors and
    topology replicated, nodes sharded."""
    out = (replicate(pods, mesh), shard_nodes(nodes, mesh),
           replicate(sel, mesh))
    if topo is not None:
        return out + (replicate(topo, mesh),)
    return out
