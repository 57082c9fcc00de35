"""The cross-shard exchanges of the partitioned node-axis solve — the
port's stand-in for the collectives GSPMD inserts into the reference's
sharded program (``kubernetes_tpu/parallel/mesh.py``). This module is the
only place shards exchange data.

**Shard programs.** The partitioned solve runs one program per shard:
shard ``i`` holds row block ``i`` of every node-axis table on
``mesh.devices[i]`` and a copy of every replicated table. A program is a
Python generator over its own block; where the reference reduces over
the node axis, it yields a request (:func:`all_max`, :func:`all_sum`,
...) carrying its per-shard partial, and gets the reduced value back on
its own device. :func:`lockstep` drives the ``d`` programs of a mesh
together, one request at a time, in one thread; :func:`solo` drives one
program alone (the unsharded solve), where every reduction over one
shard is its partial itself, so the mesh-off program issues exactly the
operations it always did.

**Reductions** (one function per row of ``costmodel.py``'s table): each
takes the ``d`` per-shard tensors, gathers them onto ``mesh.devices[0]``,
reduces there in shard order (so the result never depends on which copy
lands first) and copies the result back to every shard's device:

- :func:`all_reduce` — MAX, MIN, SUM, OR over (P,) and (P, Z) partials
  (and the (pairs, columns) zone panels of the topology passes);
- :func:`argmax_merge` — the pick: value descending, then the lowest
  global node index;
- :func:`shard_offsets` — the tie cumsum: the global tie count and each
  shard's exclusive offset;
- :func:`lse_merge` — the Sinkhorn row pass: per-shard (shift, sum)
  pairs to the row potential u;
- :func:`owner_select` — a per-pod value read from the one shard that
  owns the pod's chosen node;
- :func:`all_gather` — the shards' blocks concatenated, on every device
  or (``devices=(first,)``) on the first only: a custom priority
  kernel's whole mask, the preemption rows' ``k`` reason rows, the
  candidate pick's ``(S, C)`` winners;
- :func:`broadcast` — a value made on the first device copied to every
  shard (an assignment the shards then check or apply, block by block);
- :func:`whole_table` (and the shard-program step :func:`gather_nodes`)
  — the whole node table from its blocks, counted once per gather as
  operation ``gather_nodes``: only the passes that re-pin the whole
  table onto one device take it (the ``batch-single`` and ``batch-cpu``
  rungs, the greedy and exact tiers, a registered custom priority
  kernel, a framework batch plugin).

On a logical mesh (every device the same card) the gathers and copies
are no-ops: that is the only difference from a mesh over distinct cards.

``STATS`` counts the collectives issued from Python and the bytes they
carry: ``payload_bytes`` is what a mesh over cards moves
(``(d - 1)`` partials in and ``(d - 1)`` results out), ``moved_bytes``
what this run copied between devices (0 on a logical mesh). A round
captured into a CUDA graph issues its collectives once, at capture;
:data:`ROUND` holds the counts of the last partitioned round body the
host ran, the per-round figures ``chip_smoke.py`` prints beside
``CollectiveCostModel.per_round_collectives()``.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Generator, List, NamedTuple, Sequence

import torch

from kubernetes_tpu_torch.ops.sync import to_host

NEG_INF = -1e30


class Request(NamedTuple):
    """What a shard program yields at a reduction: the operation and this
    shard's operands."""

    op: str
    args: tuple


class Shard(NamedTuple):
    """Where a shard program runs: block ``index`` of ``count``, ``rows``
    node rows each (global node ``index * rows + j`` is local row j)."""

    index: int
    count: int
    rows: int

    @property
    def lo(self) -> int:
        return self.index * self.rows

    @property
    def n(self) -> int:
        """The global node count."""
        return self.count * self.rows


class Stats:
    """Collective calls and bytes, by operation."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.calls = 0
        self.payload_bytes = 0
        self.moved_bytes = 0
        self.by_op: Dict[str, int] = {}

    def snapshot(self) -> dict:
        return {"calls": self.calls, "payload_bytes": self.payload_bytes,
                "moved_bytes": self.moved_bytes, "by_op": dict(self.by_op)}


STATS = Stats()
#: the collectives of the last partitioned round body run on the host
#: (counted only inside :func:`round_body`)
ROUND = Stats()
_IN_ROUND = [False]


@contextlib.contextmanager
def round_body():
    """Count the collectives issued inside into :data:`ROUND`, reset
    first: the reads that follow a solve (validation, the failure pass)
    stay out of the round's figures."""
    ROUND.reset()
    _IN_ROUND[0] = True
    try:
        yield
    finally:
        _IN_ROUND[0] = False


def _stats():
    return (STATS, ROUND) if _IN_ROUND[0] else (STATS,)


# ---------------------------------------------------------------------------
# Requests a shard program yields
# ---------------------------------------------------------------------------


def all_max(x):
    return Request("max", (x,))


def all_min(x):
    return Request("min", (x,))


def all_sum(x):
    return Request("sum", (x,))


def all_or(x):
    return Request("or", (x,))


def pick(value, index):
    """Request the argmax merge of per-shard ``(value, global index)``."""
    return Request("argmax", (value, index))


def offsets(count):
    """Request ``(total, exclusive offset)`` of per-shard counts."""
    return Request("offsets", (count,))


def lse(m, s, log_r, jnp_rule: bool):
    """Request the row potential from per-shard (shift, sum) pairs."""
    return Request("lse", (m, s, log_r, jnp_rule))


def from_owner(value, owner):
    """Request, per pod, ``value`` of the shard ``owner`` names."""
    return Request("owner", (value, owner))


def cat(x, dim: int):
    """Request the concatenation of the shards' blocks along ``dim``."""
    return Request("cat", (x, dim))


def gather_nodes(nodes):
    """Shard program step: the whole node table from the shards' row
    blocks, on every shard (:func:`whole_table`'s gather, one
    ``gather_nodes`` operation). Only a custom priority kernel on a mesh
    needs it."""
    return (yield Request("gather_nodes", (nodes,)))


def host(x):
    """Request one host read of a replicated value (read on shard 0 only,
    through the counted :func:`~kubernetes_tpu_torch.ops.sync.to_host`)."""
    return Request("host", (x,))


# ---------------------------------------------------------------------------
# The reductions: d per-shard tensors in, d per-device results out
# ---------------------------------------------------------------------------


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _gather(parts: Sequence[torch.Tensor], dev0) -> List[torch.Tensor]:
    out = []
    for p in parts:
        if p.device != dev0:
            for st in _stats():
                st.moved_bytes += _nbytes(p)
        out.append(p.to(dev0))
    return out


def _scatter(res: torch.Tensor, devices) -> List[torch.Tensor]:
    out = []
    for dev in devices:
        if res.device != dev:
            for st in _stats():
                st.moved_bytes += _nbytes(res)
        out.append(res.to(dev))
    return out


def _count(op: str, d: int, part_bytes: int, res_bytes: int) -> None:
    for st in _stats():
        st.calls += 1
        st.payload_bytes += (d - 1) * (part_bytes + res_bytes)
        st.by_op[op] = st.by_op.get(op, 0) + 1


def _devices(parts, devices):
    return list(devices) if devices is not None else [p.device
                                                      for p in parts]


_FOLD = {
    "max": torch.maximum,
    "min": torch.minimum,
    "sum": torch.add,
    # bitwise: a bool partial ORs as a bool, an int32 bit set as bits
    "or": torch.bitwise_or,
}


def all_reduce(op: str, parts: Sequence[torch.Tensor],
               devices=None) -> List[torch.Tensor]:
    """All-reduce ``op`` (max, min, sum, or) of same-shaped per-shard
    partials, folded left in shard order on the first device."""
    devices = _devices(parts, devices)
    got = _gather(parts, devices[0])
    acc = got[0]
    for p in got[1:]:
        acc = _FOLD[op](acc, p)
    _count(op, len(parts), _nbytes(parts[0]), _nbytes(acc))
    return _scatter(acc, devices)


def argmax_merge(values: Sequence[torch.Tensor],
                 indices: Sequence[torch.Tensor], devices=None):
    """Merge per-shard ``(value, global index)`` proposals (each (P,)):
    the largest value wins, equal values go to the lowest index. Returns
    the merged ``(value, index)`` on every device."""
    devices = _devices(values, devices)
    vs, ix = _gather(values, devices[0]), _gather(indices, devices[0])
    bv, bi = vs[0], ix[0]
    for v, i in zip(vs[1:], ix[1:]):
        better = (v > bv) | ((v == bv) & (i < bi))
        bv, bi = torch.where(better, v, bv), torch.where(better, i, bi)
    _count("argmax", len(values), _nbytes(values[0]) + _nbytes(indices[0]),
           _nbytes(bv) + _nbytes(bi))
    return list(zip(_scatter(bv, devices), _scatter(bi, devices)))


def shard_offsets(counts: Sequence[torch.Tensor], devices=None):
    """The tie cumsum across shards: per-shard counts (each (P,) int32)
    -> ``(total, exclusive offset of shard i)`` on each device i."""
    devices = _devices(counts, devices)
    got = _gather(counts, devices[0])
    excl, acc = [], torch.zeros_like(got[0])
    for c in got:
        excl.append(acc)
        acc = acc + c
    _count("offsets", len(counts), _nbytes(counts[0]),
           _nbytes(acc) + _nbytes(excl[0]))
    total = _scatter(acc, devices)
    return [(total[i], excl[i].to(dev)) for i, dev in enumerate(devices)]


def lse_combine(m: torch.Tensor, s: torch.Tensor, log_r: torch.Tensor,
                jnp_rule: bool = False) -> torch.Tensor:
    """The merge of stacked (d, P) partials into u (plain PyTorch, the
    one spelling every caller shares): ``M = max_k m_k``,
    ``S = sum_k s_k exp(m_k - M)`` in shard order, then the pass's rule —
    ``u = log_r - (log(S + 1e-30) + M)`` with u <= NEG_INF/2 -> NEG_INF,
    or the jnp rule's ``log(S) + M`` with a non-finite u -> NEG_INF."""
    big = m.amax(0)
    tot = s[0] * torch.exp(m[0] - big)
    for k in range(1, m.shape[0]):
        tot = tot + s[k] * torch.exp(m[k] - big)
    if jnp_rule:
        u = log_r - (torch.log(tot) + big)
        return torch.where(torch.isfinite(u), u, NEG_INF)
    u = log_r - (torch.log(tot + 1e-30) + big)
    return torch.where(u > NEG_INF / 2, u, NEG_INF)


def lse_merge(ms: Sequence[torch.Tensor], ss: Sequence[torch.Tensor],
              log_r: torch.Tensor, jnp_rule: bool = False, devices=None):
    """The Sinkhorn row pass across shards: per-shard shift ``m`` and sum
    ``s`` (each (P,)) -> u on every device (:func:`lse_combine`)."""
    devices = _devices(ms, devices)
    m = torch.stack(_gather(ms, devices[0]))
    s = torch.stack(_gather(ss, devices[0]))
    u = lse_combine(m, s, log_r.to(devices[0]), jnp_rule)
    _count("lse", len(ms), 2 * _nbytes(ms[0]), _nbytes(u))
    return _scatter(u, devices)


def all_gather(parts: Sequence[torch.Tensor], dim: int, devices=None):
    """The shards' blocks concatenated along ``dim``, on every device."""
    devices = _devices(parts, devices)
    out = torch.cat(_gather(parts, devices[0]), dim)
    _count("cat", len(parts), _nbytes(parts[0]), _nbytes(out))
    return _scatter(out, devices)


def broadcast(x: torch.Tensor, devices) -> List[torch.Tensor]:
    """``x``, made on ``devices[0]``, on every device of the mesh."""
    devices = list(devices)
    _count("bcast", len(devices), 0, _nbytes(x))
    return _scatter(x, devices)


def _cat_table(blocks, dev0):
    """The whole table from its row blocks on ``dev0`` (universe-shaped
    ``zone_valid`` is the same on every block: block 0's)."""
    out = []
    for name in type(blocks[0])._fields:
        fs = [getattr(b, name) for b in blocks]
        out.append(fs[0] if name == "zone_valid"
                   else torch.cat(_gather(fs, dev0)))
    return type(blocks[0])(*out)


def whole_table(placed):
    """The whole node table of a ``parallel.mesh.ShardedNodes`` on the
    mesh's first device: one ``gather_nodes`` operation. On a logical
    mesh the blocks' parent is the table and nothing moves. Only the
    passes that re-pin the whole table onto one device call it (module
    docstring)."""
    blocks = placed.blocks
    table = (placed.whole if placed.whole is not None
             else _cat_table(blocks, placed.mesh.device))
    part = sum(_nbytes(f) for f in blocks[0])
    _count("gather_nodes", len(blocks), part, part * len(blocks))
    return table


def owner_select(values: Sequence[torch.Tensor], owner: torch.Tensor,
                 devices=None):
    """Per pod (dim 0), the value of the shard ``owner`` (P,) names —
    exact for any dtype."""
    devices = _devices(values, devices)
    got = _gather(values, devices[0])
    own = owner.to(devices[0])
    out = got[0]
    for k in range(1, len(got)):
        sel = (own == k).view((-1,) + (1,) * (out.dim() - 1))
        out = torch.where(sel, got[k], out)
    _count("owner", len(values), _nbytes(values[0]), _nbytes(out))
    return _scatter(out, devices)


# ---------------------------------------------------------------------------
# Running the shard programs
# ---------------------------------------------------------------------------


def _resolve(reqs: List[Request], devices) -> List[Any]:
    op = reqs[0].op
    if any(r.op != op for r in reqs):
        raise RuntimeError("shard programs diverged: "
                           f"{[r.op for r in reqs]}")
    cols = list(zip(*[r.args for r in reqs]))
    if op in _FOLD:
        return all_reduce(op, cols[0], devices)
    if op == "argmax":
        return argmax_merge(cols[0], cols[1], devices)
    if op == "offsets":
        return shard_offsets(cols[0], devices)
    if op == "lse":
        return lse_merge(cols[0], cols[1], cols[2][0], cols[3][0], devices)
    if op == "owner":
        return owner_select(cols[0], cols[1][0], devices)
    if op == "cat":
        return all_gather(cols[0], cols[1][0], devices)
    if op == "gather_nodes":
        from kubernetes_tpu_torch.parallel.mesh import Mesh, ShardedNodes

        table = whole_table(ShardedNodes(Mesh(tuple(devices)),
                                         tuple(cols[0])))
        return [type(table)(*[_scatter(f, [dev])[0] for f in table])
                for dev in devices]
    if op == "host":
        val = to_host(cols[0][0])
        return [val] * len(reqs)
    raise RuntimeError(f"unknown collective {op!r}")


def _resolve_one(req: Request):
    """A request of a program that runs alone: the reduction of one
    partial is the partial."""
    op, args = req
    if op in _FOLD or op in ("owner", "cat", "gather_nodes"):
        return args[0]
    if op == "argmax":
        return args
    if op == "offsets":
        return args[0], torch.zeros_like(args[0])
    if op == "lse":
        return lse_combine(args[0][None], args[1][None], args[2], args[3])
    if op == "host":
        return to_host(args[0])
    raise RuntimeError(f"unknown collective {op!r}")


Program = Generator[Request, Any, Any]


def solo(program: Program):
    """Run one shard program alone and return its result."""
    try:
        req = next(program)
        while True:
            req = program.send(_resolve_one(req))
    except StopIteration as stop:
        return stop.value


def lockstep(programs: Sequence[Program], devices) -> list:
    """Run the ``d`` shard programs of a mesh together: each runs to its
    next request, the requests are resolved across shards, and each
    program resumes with its own device's result. Returns the programs'
    results in shard order. Every program must issue the same requests in
    the same order (they are one program over different blocks)."""
    progs = list(programs)
    if len(progs) == 1:
        return [solo(progs[0])]
    pending: List[Any] = [None] * len(progs)
    results: List[Any] = [None] * len(progs)
    started = False
    while True:
        reqs, done = [], 0
        for i, g in enumerate(progs):
            try:
                reqs.append(next(g) if not started else g.send(pending[i]))
            except StopIteration as stop:
                results[i] = stop.value
                done += 1
        started = True
        if done:
            if done != len(progs):
                raise RuntimeError("shard programs diverged: some ended "
                                   "while others reduce")
            return results
        pending = _resolve(reqs, devices)
