"""One run of one cell: set-up, the measured window, the traced cycles,
the correctness check and the result line.

The traffic is a drain: the backlog (``workload.backlog``) is held at
every cycle boundary. After each cycle the run confirms every bind (the
watch's MODIFIED event) and adds as many new pending pods, from the
pool made at set-up, as the cycle bound.
"""

from __future__ import annotations

import gc
import sys
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from schedbench.core import profile, workload
from schedbench.core.profile import DeviceTrace
from schedbench.core.spec import Cell
from schedbench.reference import plain


@dataclass
class Record:
    """What the per-layer readers read: the window's cycles (their
    spans, on the scheduler's clock, and counters), the window's length
    (the sum of its steps: a traced run starts and stops the profiler
    between two steps) and, in a traced run, the device trace of a few
    whole cycles."""

    window_s: float
    cycles: List[object] = field(default_factory=list)
    harness_spans: List[tuple] = field(default_factory=list)
    device_events: List[tuple] = field(default_factory=list)
    traced_lo_us: float = 0.0
    traced_hi_us: float = 0.0
    launch_shapes: Dict[str, Dict[tuple, int]] = field(default_factory=dict)

    @property
    def traced_s(self) -> float:
        return (self.traced_hi_us - self.traced_lo_us) / 1e6


class Control:
    """The reference put in the program's place (``reference/plain.py``'s
    :class:`~schedbench.reference.plain.Greedy`, with ``drop`` left out
    of its scoring), behind the program's interface: a FIFO queue,
    batches of ``maxBatch``."""

    def __init__(self, cfg: dict, nodes, pods, drop) -> None:
        self.greedy = plain.Greedy(nodes, pods, drop)
        self.batch = int(cfg["scheduler"]["maxBatch"])
        self.queue: deque = deque()

    def sync_nodes(self) -> None:
        pass

    def make(self, ids) -> None:
        pass

    def add_bound(self, ids, nodes) -> None:
        self.greedy.st.apply(self.greedy.pods, ids, nodes)

    def add_pending(self, ids) -> None:
        self.queue.extend(ids)

    def warmup(self, sample_ids) -> int:
        return 0

    def cycle(self):
        from schedbench.core.program import CycleOut

        take = [self.queue.popleft()
                for _ in range(min(self.batch, len(self.queue)))]
        bound, where = self.greedy.place(take)
        failed = sorted(set(take) - set(bound))
        self.queue.extend(failed)
        return CycleOut(np.array(bound, np.int64), np.array(where, np.int64),
                        np.array(failed, np.int64), len(take), 1, 0, 0)

    def confirm(self, out) -> None:
        pass

    def close(self) -> None:
        pass


@dataclass
class Outcome:
    result: dict
    checks: Dict[str, dict]
    notes: List[str]


def _sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_process: Optional[float] = None,
             system_factory: Optional[Callable] = None,
             tracer: Optional[object] = None) -> Outcome:
    """Runs the cell once. ``system_factory(cfg, nodes, pods)`` puts
    another system in the program's place (the control, or the program
    with a fault planted, in the tests); ``tracer`` replaces the device
    trace (``core/profile.DeviceTrace`` on the card) in a traced run."""
    t_process = time.perf_counter() if t_process is None else t_process
    cfg, mix = cell.config, cell.mix
    notes: List[str] = []
    batch = int(cfg["scheduler"]["maxBatch"])
    nodes = workload.make_nodes(cfg)
    n_pre = workload.prefill_count(cfg)
    pool = workload.pool_size(cfg, mix, seconds)
    # the plain table holds four times the pool: pods past the pool are
    # made on the clock (a note says so)
    pods = workload.make_pods(cfg, mix, 4 * pool, seed)
    pre_ids = np.arange(n_pre, dtype=np.int64)
    pre_nodes = workload.prefill_nodes(cfg, len(nodes))

    if system_factory is None:
        from schedbench.core.program import Program

        system = Program(cfg, nodes, pods, device)
    else:
        system = system_factory(cfg, nodes, pods)
    made = n_pre + pool
    system.make(range(n_pre, made))
    # the pool is the harness's, not the system's: a deployment holds no
    # such heap, so the interpreter's full collections skip it (the
    # objects made from here on, the system's state, are still walked)
    gc.freeze()
    system.sync_nodes()
    system.add_bound(pre_ids, pre_nodes)
    backlog = workload.backlog(cfg)
    pending0 = np.arange(n_pre, n_pre + backlog, dtype=np.int64)
    system.add_pending(pending0.tolist())
    system.warmup(pending0[:int(mix.get("warm_sample", 64))].tolist())

    next_id = n_pre + backlog
    cycles: List[plain.Cycle] = []
    outs: List[object] = []
    harness_spans: List[tuple] = []

    def step(record: bool) -> object:
        """One cycle and the informer's events after it; the events of
        a window cycle (``record``) are timed."""
        nonlocal next_id, made
        out = system.cycle()
        t = time.monotonic()
        system.confirm(out)
        t1 = time.monotonic()
        k = len(out.bound)
        new = list(range(next_id, next_id + k))
        next_id += k
        if next_id > made:
            if next_id > len(pods):
                raise SystemExit("schedbench: the pod table ran out "
                                 f"({len(pods)} pods)")
            notes.append(f"pool short: made pods {made}..{next_id} on "
                         "the clock")
            system.make(range(made, next_id))
            made = next_id
        system.add_pending(new)
        t2 = time.monotonic()
        if record:
            harness_spans.extend([("informer:confirm", t, t1, 0),
                                  ("informer:add", t1, t2, 0)])
        cycles.append(plain.Cycle(out.bound, out.nodes, out.failed,
                                  out.attempted, out.rounds,
                                  np.array(new, np.int64)))
        return out

    warm_min, warm_max = int(mix["warm_cycles"]), int(mix["warm_cycles_max"])
    for w in range(warm_max):
        out = step(False)
        if w + 1 >= warm_min and out.graph_captures == 0:
            break
    _sync(device)
    n_warm = len(cycles)

    # -- the measured window ------------------------------------------------
    traced_at = int(mix.get("traced_after", 0))
    traced_s = float(mix.get("traced_seconds", 2.0))
    dtrace = (tracer or (DeviceTrace() if device == "cuda" else None)
              if trace else None)
    launch0: Dict = {}
    lo_us = hi_us = 0.0
    t0 = time.perf_counter()
    setup_s = t0 - t_process
    k, tracing, traced, steps = 0, False, None, []
    pauses = _GcPauses()
    while True:
        if dtrace is not None and k == traced_at:
            launch0 = _launch_shapes()
            dtrace.start()
            tracing, lo_us = True, time.monotonic() * 1e6
        t_step = time.perf_counter()
        outs.append(step(True))
        steps.append(time.perf_counter() - t_step)
        k += 1
        if tracing and time.monotonic() * 1e6 - lo_us >= traced_s * 1e6:
            hi_us = time.monotonic() * 1e6
            dtrace.stop()
            launch1 = _launch_shapes()
            tracing, traced = False, slice(traced_at, k)
        if time.perf_counter() - t0 >= seconds and not tracing and (
                dtrace is None or traced is not None):
            break
    window_s = time.perf_counter() - t0
    pauses.close()
    gc.unfreeze()
    notes.append("steps_s " + " ".join(f"{x:.4f}" for x in steps)
                 + f" gc_gen2 {pauses.count} gc_gen2_s {pauses.seconds:.4f}")
    _sync(device)
    peak = _memory_peak(device)
    system.close()
    del system
    if device == "cuda":
        import torch

        torch.cuda.empty_cache()

    # -- the correctness check ----------------------------------------------
    numbers = plain.judge(nodes, pods, pre_ids, pre_nodes, pending0, cycles,
                          int(cfg["scheduler"]["perNodeCap"]))
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in numbers.items()}
    bound_w = sum(len(c.bound) for c in cycles[n_warm:])
    attempted_w = sum(c.attempted for c in cycles[n_warm:])
    correct = bound_w > 0 and all(v <= cell.limits[k]
                                  for k, v in numbers.items())

    record = Record(window_s=sum(steps), cycles=outs,
                    harness_spans=harness_spans)
    metrics: Dict[str, dict] = {}
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": _kind(device), "count": 1,
                   "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted_w,
              "failed": attempted_w - bound_w}
    if not trace:
        metrics["pods_per_s"] = {"value": bound_w / window_s,
                                 "unit": "pods/s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    else:
        if dtrace is not None:
            dtrace.collect()
            record.device_events = dtrace.events
            record.traced_lo_us, record.traced_hi_us = lo_us, hi_us
            record.launch_shapes = _shapes_between(launch0, launch1)
        for m in cell.per_layer:
            v = m.read(record)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
    result["metrics"] = metrics
    result["device"] = device_info
    if trace and dtrace is not None:
        busy = profile.busy_seconds(record.device_events, lo_us, hi_us)
        device_info["busy_s"] = busy
        device_info["window_s"] = record.traced_s
        spans = _host_spans(outs[traced], harness_spans)
        result["breakdown"] = {
            "device_ops": profile.top_ops(record.device_events),
            "idle_gaps": profile.idle_gaps(record.device_events, spans,
                                           lo_us, hi_us)}
    result["checks"] = checks
    return Outcome(result, checks, notes)


class _GcPauses:
    """Counts the interpreter's full (generation 2) collections and
    their seconds while open: a run's note, for reading its noise."""

    def __init__(self) -> None:
        self.count, self.seconds, self._t = 0, 0.0, 0.0
        gc.callbacks.append(self._cb)

    def _cb(self, phase: str, info: dict) -> None:
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.count += 1
            self.seconds += time.perf_counter() - self._t

    def close(self) -> None:
        gc.callbacks.remove(self._cb)


def _host_spans(outs, harness_spans) -> List[tuple]:
    spans = [(name, a, b, len(anc) + 1) for out in outs
             for name, a, b, anc in out.spans]
    spans += [("schedule_cycle", *out.cycle_span, 0) for out in outs
              if out.cycle_span]
    return spans + [(n, a, b, d) for n, a, b, d in harness_spans]


def _launch_shapes() -> Dict[str, Dict[tuple, int]]:
    from kubernetes_tpu_torch import kernels

    kernels.collect()
    return {k: dict(v) for k, v in kernels.SHAPES.items()}


def _shapes_between(a, b) -> Dict[str, Dict[tuple, int]]:
    out = {}
    for k, shapes in b.items():
        was = a.get(k, {})
        got = {s: c - was.get(s, 0) for s, c in shapes.items()
               if c - was.get(s, 0) > 0}
        if got:
            out[k] = got
    return out


def _memory_peak(device: str) -> int:
    if device != "cuda":
        return 0
    import torch

    return int(torch.cuda.max_memory_allocated())


def _kind(device: str) -> str:
    if device != "cuda":
        return device
    import torch

    return torch.cuda.get_device_name(0)


def forbidden_modules(names=("jax", "jaxlib", "flax", "kubernetes_tpu")):
    """Loaded modules whose whole top-level name is one of ``names``."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in names)
