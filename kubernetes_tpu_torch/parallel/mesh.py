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
  block ``i`` on ``devices[i]`` (:func:`shards`). On a logical mesh the
  blocks are views of one table on the card (``ShardedNodes.whole``); on
  distinct cards no device holds the whole table: a pass that needs it
  gathers it explicitly (``collectives.whole_table``, counted);
- a tensor a shard program leaves per shard (a usage column, a score
  summary's rank, a filter result's column block) is a :class:`Blocks`:
  part ``i`` on ``devices[i]``, split along the node axis (rows, or the
  columns of a (P, N) plane); a table of them keeps its type, a
  :class:`Blocks` in each field;
- a replicated table is a :class:`Replicated`: one copy on every device
  (the same object ``d`` times on a logical mesh).

Every pass a cycle runs over the node axis goes through
:func:`per_shard` (``run_predicates``, ``explain_reduce``,
``device_validate``, ``quality_reduce``, the candidate pick and its row
gather, the usage updates; ``batch_assign`` drives its own rounds): off
the mesh the unsharded program once, on it one program per shard over
its own block, the cross-shard reductions explicit in
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
        """The first device: where the replicated results land and the
        host reads them."""
        return self.devices[0]

    @property
    def logical(self) -> bool:
        """Whether every shard shares one device."""
        return len(set(self.devices)) == 1


class ShardedNodes(NamedTuple):
    """A node table placed on a mesh of ``d > 1`` devices: ``blocks[i]``
    (a ``DeviceNodes`` of ``N / d`` rows) on ``mesh.devices[i]``.
    ``whole`` is the blocks' parent on a logical mesh (one card holds the
    table once) and None otherwise: on distinct cards no device holds the
    whole table."""

    mesh: Mesh
    blocks: tuple
    whole: object = None

    @property
    def n(self) -> int:
        """The padded global node count."""
        return self.rows * self.mesh.size

    @property
    def rows(self) -> int:
        """Rows of one block."""
        return self.blocks[0].n


class Blocks(NamedTuple):
    """A tensor split along the node axis of a mesh: ``parts[i]`` on
    ``mesh.devices[i]``. ``axis`` 0 splits node rows (a usage column, a
    score summary's rank), 1 the columns of a (P, N) plane (a filter
    result's mask, a score term). A table of such tensors (a
    ``FilterResult``, a ``UsageState``, a ``NodeSummary``) keeps its own
    type with a :class:`Blocks` in each field (:func:`join`)."""

    mesh: Mesh
    parts: tuple
    axis: int = 0


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


def shard_nodes(nodes, mesh: Mesh):
    """Place a ``DeviceNodes`` on the mesh: node-axis tensors split into
    the mesh's row blocks, universe-shaped ones (``zone_valid``)
    replicated. The node axis must divide across the mesh (callers pad
    the bucket up to the mesh size; both are powers of two). A mesh of
    one device returns the table on its device. On a logical mesh the
    blocks are views of the table, which stays their parent; on distinct
    cards only the blocks are kept."""
    if isinstance(nodes, ShardedNodes):
        return nodes
    _check_divides(nodes.allocatable.shape[0], mesh)
    if mesh.size == 1:
        return type(nodes)(*[_to(f, mesh.device) for f in nodes])
    if not mesh.logical:
        return ShardedNodes(mesh, _blocks(nodes, mesh))
    whole = type(nodes)(*[_to(f, mesh.device) for f in nodes])
    return ShardedNodes(mesh, _blocks(whole, mesh), whole)


def node_blocks(nodes) -> tuple:
    """The row blocks of a node table: those of a :class:`ShardedNodes`,
    else the table itself as the one block."""
    return nodes.blocks if isinstance(nodes, ShardedNodes) else (nodes,)


def place_node_table(table, mesh: Mesh, pad_to: Optional[int] = None):
    """Host ``NodeTable`` -> mesh-placed nodes in one call: pad the node
    bucket up to the mesh size and upload. On a mesh of one device, or a
    logical mesh, the table is uploaded once (the blocks are its views);
    on distinct cards each block goes straight from the host to its card
    and nothing else is uploaded. Returns a ``DeviceNodes`` on a mesh of
    one, else a :class:`ShardedNodes`. The one placement seam of the
    cache's full rebuild, the host-mode cycle and the warmup."""
    from kubernetes_tpu_torch.ops.arrays import nodes_to_device
    from kubernetes_tpu_torch.utils.interner import bucket_size

    n_pad = pad_to or bucket_size(max(table.n, 1))
    n_pad = max(n_pad, mesh.size)
    if mesh.size == 1 or mesh.logical:
        return shard_nodes(
            nodes_to_device(table, pad_to=n_pad, device=mesh.device), mesh)
    _check_divides(n_pad, mesh)
    rows = n_pad // mesh.size
    return ShardedNodes(mesh, tuple(
        nodes_to_device(_row_block(table, i * rows, (i + 1) * rows),
                        pad_to=rows, device=dev)
        for i, dev in enumerate(mesh.devices)))


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
    ``sub``'s rows at host rows ``idx``: on a logical mesh the scatter
    went into the parent, which produced ``whole_new``, and the blocks
    are views of it again; on distinct cards (``whole_new`` None) each
    row lands in the one block that owns it (``ops/arrays.
    scatter_node_rows``, in place)."""
    mesh = placed.mesh
    if mesh.logical:
        return shard_nodes(whole_new, mesh)
    from kubernetes_tpu_torch.ops.arrays import scatter_node_rows

    return ShardedNodes(mesh, tuple(
        scatter_node_rows(b, type(sub)(*[_to(f, dev) for f in sub]), local)
        for b, dev, local in zip(placed.blocks, mesh.devices,
                                 local_rows(idx, placed.rows, mesh.size))))


def local_rows(idx, rows: int, count: int) -> list:
    """Host row indices ``idx`` as each of ``count`` blocks of ``rows``
    rows sees them: a block's own rows at their local index, every other
    row at ``rows`` (a padding index the scatters drop)."""
    import numpy as np

    # graftlint: disable=R7,R8 -- host row indices
    idx = np.asarray(idx, np.int64)
    out = []
    for i in range(count):
        mine = (idx >= i * rows) & (idx < (i + 1) * rows)
        out.append(np.where(mine, idx - i * rows, rows))
    return out


def shard_usage(u, mesh: Mesh):
    """Shard a node-axis usage table (``ops/assign.UsageState``, every
    field (N, ...)) along the mesh, as the resident table is: the
    ``UsageState`` of :class:`Blocks` (the table itself on a mesh of
    one)."""
    if mesh.size == 1:
        return type(u)(*[_to(f, mesh.device) for f in u])
    return join(_blocks(u, mesh, whole_field=()), mesh)


def row_blocks(x, mesh: Mesh) -> Blocks:
    """A node-axis tensor (N, ...) on one device as the :class:`Blocks`
    of its row blocks, block i placed on ``devices[i]`` (views on a
    logical mesh); a :class:`Blocks` passes through."""
    if isinstance(x, Blocks):
        return x
    return Blocks(mesh, tuple(_to(b, dev) for b, dev in
                              zip(x.chunk(mesh.size, 0), mesh.devices)))


def column_blocks(x, mesh: Mesh) -> Optional[Blocks]:
    """A (P, N) plane as the :class:`Blocks` of its column blocks, block
    i on ``devices[i]`` (views on a logical mesh); a :class:`Blocks` and
    None pass through. Placement, not an exchange: the plane was made on
    the first device (a plugin's or the host's term)."""
    if x is None or isinstance(x, Blocks):
        return x
    return Blocks(mesh, tuple(_to(b, dev) for b, dev in
                              zip(x.chunk(mesh.size, 1), mesh.devices)), 1)


def upload_rows(host, mesh: Mesh) -> Blocks:
    """A host node-axis array (N, ...) uploaded as row blocks, block i
    straight to ``devices[i]`` (``ops/arrays.upload``)."""
    from kubernetes_tpu_torch.ops.arrays import upload

    rows = host.shape[0] // mesh.size
    return Blocks(mesh, tuple(upload(host[i * rows:(i + 1) * rows], dev)
                              for i, dev in enumerate(mesh.devices)))


def _table(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def is_placed(x) -> bool:
    """Whether ``x`` lies in a mesh's node-axis blocks: a
    :class:`ShardedNodes`, a :class:`Blocks`, or a table with a
    :class:`Blocks` field."""
    if isinstance(x, (ShardedNodes, Blocks)):
        return True
    return _table(x) and any(isinstance(f, Blocks) for f in x)


def _has_tensor(x) -> bool:
    if isinstance(x, torch.Tensor):
        return True
    return isinstance(x, (tuple, list)) and any(_has_tensor(f) for f in x)


def _mesh_of(x) -> Optional[Mesh]:
    if isinstance(x, (ShardedNodes, Blocks)):
        return x.mesh
    if _table(x):
        for f in x:
            if isinstance(f, Blocks):
                return f.mesh
    return None


def _rows_of(x) -> int:
    if isinstance(x, ShardedNodes):
        return x.rows
    if isinstance(x, Blocks):
        return x.parts[0].shape[x.axis]
    return next(_rows_of(f) for f in x if isinstance(f, Blocks))


def part(x, i: int):
    """Shard ``i``'s view of a value: block ``i`` of a
    :class:`ShardedNodes`, part ``i`` of a :class:`Blocks` (and of each
    :class:`Blocks` field of a table), copy ``i`` of a
    :class:`Replicated`; anything else as it is."""
    if isinstance(x, ShardedNodes):
        return x.blocks[i]
    if isinstance(x, Blocks):
        return x.parts[i]
    if isinstance(x, Replicated):
        return x.copies[i]
    if is_placed(x):
        return type(x)(*[part(f, i) for f in x])
    return x


def join(outs: Sequence, mesh: Mesh, axis: int = 0):
    """The ``d`` per-shard values of a mesh as one placed value: a
    :class:`Blocks` of tensors, or a table of the parts' type with each
    field joined (None fields stay None)."""
    o0 = outs[0]
    if o0 is None:
        return None
    if isinstance(o0, torch.Tensor):
        return Blocks(mesh, tuple(outs), axis)
    return type(o0)(*[join([o[k] for o in outs], mesh, axis)
                      for k in range(len(o0))])


def per_shard(program, *args, split: Optional[int] = None,
              shard: bool = False, **kw):
    """Run ``program`` over the placement of its node-axis arguments: the
    one dispatch of every pass a cycle runs over the node axis.

    No argument placed (:func:`is_placed`): ``program(*args, **kw)``
    once (a :class:`Replicated` as its first copy); a shard program (a
    generator) runs alone (``collectives.solo``), where every reduction
    is its own partial.
    On a mesh of ``d``: one call per shard ``i``, each placed argument
    as its part ``i`` (:func:`part`), a :class:`Replicated` as its copy
    ``i``, any other tensor broadcast from the first device (a counted
    ``collectives.broadcast``), any other table replicated, everything
    else as it is; ``shard=True`` adds ``sh=collectives.Shard(i, d,
    rows)``. Shard programs run in lockstep (``collectives.lockstep``).

    Returns, with ``split`` None, shard 0's result (a merged value on
    the first device); with ``split`` 0 or 1, the shards' results joined
    along that axis (:func:`join`): node rows, or a (P, N) plane's
    columns."""
    import inspect

    from kubernetes_tpu_torch.parallel import collectives as coll

    placed = [a for a in list(args) + list(kw.values()) if is_placed(a)]
    if not placed:
        out = program(*[unreplicated(a) for a in args],
                      **{k: unreplicated(v) for k, v in kw.items()})
        return coll.solo(out) if inspect.isgenerator(out) else out
    mesh = _mesh_of(placed[0])
    d = mesh.size

    def spread(x):
        if is_placed(x) or isinstance(x, Replicated):
            return [part(x, i) for i in range(d)]
        if isinstance(x, torch.Tensor):
            return coll.broadcast(x, mesh.devices)
        if isinstance(x, tuple) and _has_tensor(x):
            return list(replicas(x, mesh))
        return [x] * d

    pos = [spread(a) for a in args]
    named = {k: spread(v) for k, v in kw.items()}
    if shard:
        rows = _rows_of(placed[0])
        named["sh"] = [coll.Shard(i, d, rows) for i in range(d)]
    outs = [program(*[a[i] for a in pos],
                    **{k: v[i] for k, v in named.items()})
            for i in range(d)]
    if inspect.isgenerator(outs[0]):
        outs = coll.lockstep(outs, mesh.devices)
    return outs[0] if split is None else join(outs, mesh, split)


class Abstract(NamedTuple):
    """A tensor's shape and dtype, no data: what a signature digest and a
    byte count read."""

    shape: tuple
    dtype: torch.dtype

    def element_size(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()


def abstract(x):
    """The signature of a node-axis value as the unsharded value would
    show it: a :class:`ShardedNodes`, a :class:`Blocks` or a table of
    them becomes its global-shaped :class:`Abstract` tree (so a mesh
    cycle digests and counts bytes as its mesh-off twin does); anything
    else is itself."""
    if isinstance(x, ShardedNodes):
        b0 = x.blocks[0]
        return type(b0)(*[
            f if name == "zone_valid" else
            Abstract((x.n,) + tuple(f.shape[1:]), f.dtype)
            for name, f in zip(type(b0)._fields, b0)])
    if isinstance(x, Blocks):
        shape = list(x.parts[0].shape)
        shape[x.axis] *= x.mesh.size
        return Abstract(tuple(shape), x.parts[0].dtype)
    if is_placed(x):
        return type(x)(*[abstract(f) for f in x])
    return x


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
