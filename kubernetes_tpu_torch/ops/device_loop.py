"""The assignment round loop, kept on the device.

The reference runs its round loops as ``jax.lax.while_loop``
(``kubernetes_tpu/ops/assign.py:544-552``, ``:893-913``): the exit test
is evaluated on the device, and the host reads the round count once, with
the result. :func:`run` gives the port the same shape.

- **CUDA tensors.** Round 0 runs eagerly (it is where the auto-router
  makes its one counted decision, :mod:`.sync`). The later rounds are one
  CUDA graph: the round body is captured once by PyTorch's stream capture
  and looped on the card by a conditional WHILE node
  (``csrc/graph_loop.cu``), whose exit kernel bumps the device round
  counter. The host enqueues the loop and returns; nothing is read back,
  so a caller can pack or bind while the loop runs.
- **CPU tensors.** The plain Python loop, as the plain versions of the
  kernels are: its exit tests are host reads of host tensors, not device
  syncs, and are not counted.

One graph is cached per (shapes and dtypes of every input, the statics
the body bakes in, round 0's tag, ``max_rounds``): a cached graph reads
its inputs from fixed buffers, so each run copies the inputs there
(device to device, stream-ordered) and clones the results out. Every
capture counts in ``CAPTURES``, and every loop run adds its key to
``KEYS`` (on CPU tensors too: the key a card would cache the graph
under, so a test can check the warmup's coverage without a card).
Graphs captured under :func:`pinning` (the scheduler's warmup) stay
cached outside the ``CACHE_SIZE`` bound, so a warmed shape never
captures again. A capture or launch that
fails raises :class:`~kubernetes_tpu_torch.kernels.KernelError`; there is
no quiet fall-back to the Python loop.

A round body must keep every shape static (no ``nonzero``, no boolean
indexing, no ``.item()``): the capture refuses anything else.

The partitioned round of a node-axis mesh (``ops/assign.py``) is one
body over per-shard inputs and states. On a logical mesh (every shard
on one card) it is one device's work and loops as above; its key
carries the shard count (the ``statics`` and the blocks' shapes). On
distinct cards one graph cannot span the devices, so the caller passes
``statics=None`` and the rounds take the Python loop, whose exit test
is one counted read a round: ``rounds + 1`` syncs a solve (the batch's
any-valid test and each round's exit), besides the auto-router's one.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
from typing import Callable, List, Optional, Tuple

import torch

from kubernetes_tpu_torch import kernels
from kubernetes_tpu_torch.ops.sync import to_host

#: cached loop graphs kept per process besides the pinned ones (the
#: oldest unpinned graph is dropped beyond it)
CACHE_SIZE = 8


class CaptureCounter:
    """A running count of round-loop graph captures (cache misses)."""

    def __init__(self) -> None:
        self.count = 0


CAPTURES = CaptureCounter()

#: the cache key of every loop run (see :func:`run`)
KEYS: set = set()

#: (round body, ctx, state, first round?, tag) -> (state, cont, tag)
RoundFn = Callable[..., Tuple[object, torch.Tensor, object]]


def _flatten(x, tensors: List[torch.Tensor]):
    """The structure of ``x`` as a hashable signature; its tensors are
    appended to ``tensors`` in walk order (shape and dtype stay in the
    signature, values do not)."""
    if isinstance(x, torch.Tensor):
        tensors.append(x)
        return ("T", tuple(x.shape), x.dtype)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (type(x), tuple(_flatten(v, tensors) for v in x))
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_flatten(v, tensors) for v in x))
    if isinstance(x, dict):
        return (dict, tuple((k, _flatten(v, tensors)) for k, v in x.items()))
    if x is None or isinstance(x, (bool, int, float, str)):
        return ("S", x)
    raise TypeError(f"device loop: unsupported input {type(x).__name__}")


def _rebuild(x, it):
    """``x`` with its tensors replaced, in walk order, from ``it``."""
    if isinstance(x, torch.Tensor):
        return next(it)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_rebuild(v, it) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(_rebuild(v, it) for v in x)
    if isinstance(x, dict):
        return {k: _rebuild(v, it) for k, v in x.items()}
    return x


def _tensors(x) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _flatten(x, out)
    return out


class _Loop:
    """One captured round body inside its WHILE graph, with the fixed
    buffers it reads (``ctx``), updates (``state``) and tests (``rounds``,
    ``cont``)."""

    def __init__(self, round_fn: RoundFn, ctx, state, tag, max_rounds: int,
                 device, shape) -> None:
        self.device = device
        self.shape = tuple(shape)
        self.ctx_leaves = [t.clone() for t in _tensors(ctx)]
        self.state_leaves = [t.clone() for t in _tensors(state)]
        ctx_s = _rebuild(ctx, iter(self.ctx_leaves))
        state_s = _rebuild(state, iter(self.state_leaves))
        self.rounds = torch.zeros((), dtype=torch.int32, device=device)
        self.cont = torch.zeros((), dtype=torch.int32, device=device)
        self.done: Optional[torch.cuda.Event] = None
        self.exec = None
        lib = kernels.lib("graph_loop")
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        try:
            with torch.cuda.stream(side), kernels.counting_on_device(device):
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    new, cont, _tag = round_fn(ctx_s, state_s, False, tag)
                    got = _tensors(new)
                    if [(t.shape, t.dtype) for t in got] != [
                            (t.shape, t.dtype) for t in self.state_leaves]:
                        raise TypeError("the round body changed its state's "
                                        "shapes or dtypes")
                    for dst, src in zip(self.state_leaves, got):
                        if dst.data_ptr() != src.data_ptr():
                            dst.copy_(src)
                    self.cont.copy_(cont)
                finally:
                    self.graph.capture_end()
        except kernels.KernelError:
            raise
        except Exception as e:  # noqa: BLE001 — every capture fault
            raise kernels.KernelError(
                f"round loop: capturing the round body failed: {e}") from e
        finally:
            torch.cuda.current_stream(device).wait_stream(side)
        handle = ctypes.c_void_p()
        code = lib.ktt_loop_build(self.graph.raw_cuda_graph(),
                                  self.rounds.data_ptr(),
                                  self.cont.data_ptr(), int(max_rounds),
                                  ctypes.addressof(handle))
        kernels.check(code, "round loop: building the WHILE graph")
        self.exec = handle.value

    def run(self, ctx, state, rounds: torch.Tensor, cont: torch.Tensor):
        """Copy the inputs into the fixed buffers, enqueue the loop and
        return ``(state, rounds)`` as fresh tensors (no sync)."""
        for dst, src in zip(self.ctx_leaves, _tensors(ctx)):
            dst.copy_(src)
        for dst, src in zip(self.state_leaves, _tensors(state)):
            dst.copy_(src)
        self.rounds.copy_(rounds)
        self.cont.copy_(cont)
        stream = torch.cuda.current_stream(self.device)
        code = kernels.lib("graph_loop").ktt_loop_launch(self.exec,
                                                         stream.cuda_stream)
        kernels.check(code, "round loop: launching the WHILE graph")
        kernels.count_launch("round_loop", self.shape)
        out = _rebuild(state, iter([t.clone() for t in self.state_leaves]))
        rounds_out = self.rounds.clone()
        self.done = torch.cuda.Event()
        self.done.record(stream)
        return out, rounds_out

    def release(self) -> None:
        if self.exec is not None:
            kernels.check(kernels.lib("graph_loop").ktt_loop_destroy(
                self.exec), "round loop: destroying the WHILE graph")
            self.exec = None
        self.graph = None


_cache: "collections.OrderedDict[tuple, _Loop]" = collections.OrderedDict()
#: evicted loops whose last launch may still be running
_retired: List[_Loop] = []
#: keys of the cached loops that eviction skips
_pinned: set = set()
#: whether loops run now are pinned (inside :func:`pinning`)
_pin_now = [False]


@contextlib.contextmanager
def pinning():
    """Every loop captured or reused inside the block stays cached until
    :func:`clear` (the warmup's graphs)."""
    _pin_now[0] = True
    try:
        yield
    finally:
        _pin_now[0] = False


def pinned_count() -> int:
    return len(_pinned)


def _sweep() -> None:
    """Free the retired loops whose last launch has finished (an event
    query, never a wait)."""
    keep = []
    for loop in _retired:
        if loop.done is None or loop.done.query():
            loop.release()
        else:
            keep.append(loop)
    _retired[:] = keep


def clear() -> None:
    """Drop every cached loop (their memory is freed once idle)."""
    _retired.extend(_cache.values())
    _cache.clear()
    _pinned.clear()
    _sweep()


def _host_loop(round_fn: RoundFn, ctx, state, valid, max_rounds: int):
    dev = valid.device

    def read(t) -> bool:
        # a CPU tensor is the plain path: no device, no sync to count
        return bool(t) if dev.type == "cpu" else bool(to_host(t))

    rounds = 0
    tag = first_tag = None
    more = max_rounds > 0 and read(valid.any())
    while more and rounds < max_rounds:
        state, cont, tag = round_fn(ctx, state, rounds == 0, tag)
        if rounds == 0:
            first_tag = tag
        rounds += 1
        more = read(cont)
    # filled on the device: an upload would wait for the stream
    return (state, torch.full((), rounds, dtype=torch.int32, device=dev),
            first_tag)


def _key(ctx, state, statics, tag, max_rounds: int, dev) -> tuple:
    return (_flatten(ctx, []), _flatten(state, []), statics, tag,
            int(max_rounds), str(dev))


def run(round_fn: RoundFn, ctx, state, valid: torch.Tensor, max_rounds: int,
        statics: Optional[tuple] = None, shape: Tuple[int, ...] = ()):
    """Run assignment rounds until one admits nobody, nothing is left to
    place, or ``max_rounds`` ran. ``round_fn(ctx, state, first, tag)``
    returns ``(state, cont, tag)``: ``cont`` a 0-d bool tensor (the round
    admitted somebody and somebody is left), ``tag`` what round 0 decided
    for the later rounds (hashable). ``valid`` is the batch's (P,) pod
    validity. Returns ``(state, rounds)`` with ``rounds`` an int32 0-d
    tensor on ``valid``'s device.

    ``statics`` (hashable) names everything the body bakes in besides its
    inputs' shapes; ``None`` keeps the Python loop even on a CUDA tensor
    (a body that must read the host, such as the tolerance-gated
    Sinkhorn, whose reads are then counted syncs). ``shape`` is the
    batch's (P, N), for the launch count of the loop."""
    dev = valid.device
    if dev.type != "cuda" or statics is None:
        out, rounds, tag = _host_loop(round_fn, ctx, state, valid,
                                      max_rounds)
        if statics is not None and max_rounds > 1:
            KEYS.add(_key(ctx, state, statics, tag, max_rounds, dev))
        return out, rounds
    if max_rounds <= 0:
        return state, torch.zeros((), dtype=torch.int32, device=dev)
    _sweep()
    any_valid = valid.any()
    new, cont, tag = round_fn(ctx, state, True, None)
    # a batch without a valid pod runs no round at all
    state = _rebuild(new, iter([
        torch.where(any_valid, a, b)
        for a, b in zip(_tensors(new), _tensors(state))]))
    rounds = any_valid.to(torch.int32)
    if max_rounds == 1:
        return state, rounds
    cont = (cont & any_valid).to(torch.int32)
    key = _key(ctx, state, statics, tag, max_rounds, dev)
    KEYS.add(key)
    if _pin_now[0]:
        _pinned.add(key)
    loop = _cache.get(key)
    if loop is None:
        loop = _Loop(round_fn, ctx, state, tag, max_rounds, dev, shape)
        CAPTURES.count += 1
        _cache[key] = loop
        _evict()
    else:
        _cache.move_to_end(key)
    return loop.run(ctx, state, rounds, cont)


def _evict() -> None:
    """Retire the oldest unpinned loops beyond ``CACHE_SIZE``."""
    unpinned = [k for k in _cache if k not in _pinned]
    for k in unpinned[: max(len(unpinned) - CACHE_SIZE, 0)]:
        _retired.append(_cache.pop(k))
