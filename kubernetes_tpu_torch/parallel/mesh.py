"""The node-axis device mesh (the port of ``kubernetes_tpu/parallel/mesh.py``).

The reference shards the node axis of every (pods x nodes) table across a
1-D ``jax.sharding.Mesh`` and lets XLA's partitioner insert the
cross-device reductions; pods and selector tables are replicated. The
port keeps that layout and its vocabulary, with the partitioner written
out:

- a :class:`Mesh` is a tuple of devices of one type with the one axis
  :data:`NODE_AXIS`: distinct cards (``cuda:0..cuda:d-1``), or one card
  repeated (a *logical* mesh);
- a node-axis table on a mesh of ``d > 1`` devices is a
  :class:`ShardedNodes`: ``d`` contiguous row blocks of ``N / d`` rows,
  block ``i`` on ``devices[i]`` (:func:`shards`), beside the whole table
  on ``devices[0]`` that the reads outside the partitioned solve use (on
  a logical mesh the blocks are views of it; on distinct cards it is a
  mirror the cache keeps in step);
- a replicated table is a :class:`Replicated`: one copy on every device
  (the same object ``d`` times on a logical mesh).

``batch_assign`` dispatches on :class:`ShardedNodes`: one program per
shard over its own block, the cross-shard reductions explicit in
:mod:`.collectives` (the only place shards exchange data). A mesh of one
device keeps the unsharded program — the reference's partitioner is the
identity there — so the placement helpers return the table itself.

The placement helpers (:func:`shard_nodes`, :func:`replicate`,
:func:`shard_usage`, :func:`shard_cluster`) keep the reference's
vocabulary and its checks (a node axis that does not divide across the
mesh is refused); :func:`place_node_table` pads the bucket up to the
mesh size and uploads each block straight to its device. A mesh that
mixes device types raises :class:`MeshError`.

``local_devices`` is what ``"auto"`` and a device count resolve against:
every CUDA device, or the CPU when the scheduler runs on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from kubernetes_tpu_torch.utils import klog

NODE_AXIS = "nodes"


class MeshError(ValueError):
    """A mesh the port cannot run: one that mixes device types."""


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
        """The first device: where the replicated results and the whole
        table live."""
        return self.devices[0]

    @property
    def logical(self) -> bool:
        """Whether every shard shares one device."""
        return len(set(self.devices)) == 1


class ShardedNodes(NamedTuple):
    """A node table placed on a mesh of ``d > 1`` devices: ``blocks[i]``
    (a ``DeviceNodes`` of ``N / d`` rows) on ``mesh.devices[i]``, and the
    whole table on ``mesh.devices[0]`` (the blocks' parent on a logical
    mesh)."""

    mesh: Mesh
    blocks: tuple
    whole: object

    @property
    def n(self) -> int:
        return self.whole.n

    @property
    def rows(self) -> int:
        """Rows of one block."""
        return self.blocks[0].n


class Replicated(NamedTuple):
    """A table with one copy on every mesh device, in mesh order."""

    mesh: Mesh
    copies: tuple

    @property
    def value(self):
        return self.copies[0]


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
    keeps its largest power-of-two prefix, with a warning. The devices
    may be distinct cards or one device repeated (a logical mesh); a
    mesh that mixes device types raises :class:`MeshError`."""
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
    kinds = sorted({d.type for d in devices})
    if len(kinds) > 1:
        raise MeshError(
            f"mesh over {[str(d) for d in devices]} mixes device types "
            f"{kinds}: a node-axis mesh holds devices of one type")
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
    ``[i * N/d, (i+1) * N/d)`` (views of ``t``)."""
    return tuple(t.chunk(mesh.size, 0))


def _to(t: Optional[torch.Tensor], dev):
    return t if t is None or t.device == dev else t.to(dev)


def _check_divides(n: int, mesh: Mesh) -> None:
    if n % max(mesh.size, 1):
        raise ValueError(
            f"shard_nodes: node axis {n} not divisible by {mesh.size} mesh "
            f"devices — pad the node bucket to at least {mesh.size} rows")


def _blocks(table, mesh: Mesh, whole_field=("zone_valid",)):
    """Row blocks of a node-axis NamedTuple, block ``i`` on
    ``devices[i]``; universe-shaped fields replicate whole."""
    out = []
    for i, dev in enumerate(mesh.devices):
        fields = []
        for name, f in zip(type(table)._fields, table):
            if name in whole_field:
                fields.append(_to(f, dev))
            else:
                fields.append(_to(f.chunk(mesh.size, 0)[i], dev))
        out.append(type(table)(*fields))
    return tuple(out)


def shard_nodes(nodes, mesh: Mesh, placed: Optional[ShardedNodes] = None):
    """Place a ``DeviceNodes`` on the mesh: node-axis tensors split into
    the mesh's row blocks, universe-shaped ones (``zone_valid``)
    replicated. The node axis must divide across the mesh (callers pad
    the bucket up to the mesh size; both are powers of two). A mesh of
    one device returns the table on its device. ``placed``: an earlier
    placement of this very table (its blocks are reused)."""
    if isinstance(nodes, ShardedNodes):
        return nodes
    _check_divides(nodes.allocatable.shape[0], mesh)
    if mesh.size == 1:
        return type(nodes)(*[_to(f, mesh.device) for f in nodes])
    if placed is not None and placed.whole is nodes \
            and placed.mesh == mesh:
        return placed
    whole = type(nodes)(*[_to(f, mesh.device) for f in nodes])
    return ShardedNodes(mesh, _blocks(whole, mesh), whole)


def whole(nodes):
    """The whole node table on ``mesh.devices[0]`` (the table itself when
    it is not sharded)."""
    return nodes.whole if isinstance(nodes, ShardedNodes) else nodes


def place_node_table(table, mesh: Mesh, pad_to: Optional[int] = None):
    """Host ``NodeTable`` -> mesh-placed nodes in one call: pad the node
    bucket up to the mesh size and upload. On a mesh of one device, or a
    logical mesh, the table is uploaded once (the blocks are its views);
    on distinct cards each block goes straight from the host to its
    card, and the whole table to ``devices[0]``. Returns a
    ``DeviceNodes`` on a mesh of one, else a :class:`ShardedNodes`. The
    one placement seam of the cache's full rebuild, the host-mode cycle
    and the warmup."""
    from kubernetes_tpu_torch.ops.arrays import nodes_to_device
    from kubernetes_tpu_torch.utils.interner import bucket_size

    n_pad = pad_to or bucket_size(max(table.n, 1))
    n_pad = max(n_pad, mesh.size)
    whole_dev = nodes_to_device(table, pad_to=n_pad, device=mesh.device)
    if mesh.size == 1 or mesh.logical:
        return shard_nodes(whole_dev, mesh)
    _check_divides(n_pad, mesh)
    rows = n_pad // mesh.size
    return ShardedNodes(mesh, tuple(
        nodes_to_device(_row_block(table, i * rows, (i + 1) * rows),
                        pad_to=rows, device=dev)
        for i, dev in enumerate(mesh.devices)), whole_dev)


def _row_block(table, lo: int, hi: int):
    """Rows ``[lo, hi)`` of a host ``NodeTable`` (fewer where the table
    ends first; ``nodes_to_device`` pads the block as it pads a table)."""
    import dataclasses

    top = max(min(hi, table.n), lo)
    return dataclasses.replace(table, n=top - lo, **{
        f.name: getattr(table, f.name)[lo:top]
        for f in dataclasses.fields(table)
        if f.name not in ("n", "zone_valid")})


def scatter_placed(placed: ShardedNodes, whole_new, sub, idx):
    """Keep a :class:`ShardedNodes` in step with a delta scatter of
    ``sub``'s rows at host rows ``idx`` that produced ``whole_new``: on a
    logical mesh the blocks are views of it again; on distinct cards each
    row lands in the one block that owns it (``ops/arrays.
    scatter_node_rows``, in place)."""
    mesh = placed.mesh
    if mesh.logical:
        return shard_nodes(whole_new, mesh)
    import numpy as np

    from kubernetes_tpu_torch.ops.arrays import scatter_node_rows

    idx = np.asarray(idx, np.int64)  # graftlint: disable=R7 -- host row indices
    rows = placed.rows
    blocks = []
    for i, (b, dev) in enumerate(zip(placed.blocks, mesh.devices)):
        mine = (idx >= i * rows) & (idx < (i + 1) * rows)
        local = np.where(mine, idx - i * rows, rows)  # rows: dropped
        blocks.append(scatter_node_rows(
            b, type(sub)(*[_to(f, dev) for f in sub]), local))
    return ShardedNodes(mesh, tuple(blocks), whole_new)


def shard_usage(u, mesh: Mesh):
    """Shard a node-axis usage table (``ops/assign.UsageState``, every
    field (N, ...)) along the mesh, as the resident table is: a tuple of
    ``d`` per-block usage tables (the table itself on a mesh of one)."""
    if mesh.size == 1:
        return type(u)(*[_to(f, mesh.device) for f in u])
    return _blocks(u, mesh, whole_field=())


def gather_usage(blocks, dev):
    """The inverse of :func:`shard_usage`: per-block usage tables -> one
    table on ``dev``."""
    return type(blocks[0])(*[torch.cat([_to(b[i], dev) for b in blocks])
                             for i in range(len(blocks[0]))])


def _place_tree(tree, dev):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return _to(tree, dev)
    out = [_place_tree(f, dev) for f in tree]
    return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)


def replicate(tree, mesh: Mesh):
    """Replicate a table (pods, selectors, topology) across the mesh: a
    :class:`Replicated` with one copy per device (the table itself on a
    mesh of one)."""
    if tree is None or isinstance(tree, Replicated):
        return tree
    if mesh.size == 1:
        return _place_tree(tree, mesh.device)
    if mesh.logical:
        one = _place_tree(tree, mesh.device)
        return Replicated(mesh, (one,) * mesh.size)
    return Replicated(mesh, tuple(_place_tree(tree, d)
                                  for d in mesh.devices))


def replicas(tree, mesh: Mesh) -> tuple:
    """The per-device copies of a table: those of a :class:`Replicated`,
    else copies made now."""
    if tree is None:
        return (None,) * mesh.size
    if not isinstance(tree, Replicated):
        tree = replicate(tree, mesh)
        if not isinstance(tree, Replicated):
            return (tree,)
    return tree.copies


def unreplicated(tree):
    """The copy on the first device of a replicated table (the table
    itself otherwise)."""
    return tree.value if isinstance(tree, Replicated) else tree


def shard_cluster(pods, nodes, sel, mesh: Mesh, topo=None):
    """One-call placement of a cycle's inputs: pods, selectors and
    topology replicated, nodes sharded."""
    out = (replicate(pods, mesh), shard_nodes(nodes, mesh),
           replicate(sel, mesh))
    if topo is not None:
        return out + (replicate(topo, mesh),)
    return out
