"""Cache debugger — dump + compare, the analog of
``pkg/scheduler/internal/cache/debugger/`` (SIGUSR2 handler: ``dumper.go``
prints the cache, ``comparer.go`` diffs cache/queue state against the
apiserver's). The sim harness uses the comparer as its consistency oracle;
a host shim can wire :func:`install_signal_handler` for the SIGUSR2
behavior. (The port's copy of ``kubernetes_tpu/debugger.py``; ``dump``
prints the flight recorder, and skips the memory ledger and the incident
recorder the port does not have yet, ROADMAP A.13 slice 2.)"""

from __future__ import annotations

import signal
from typing import Dict, List, Tuple


def dump(scheduler) -> str:
    """dumper.go:40 — a readable snapshot of cached nodes (+ usage),
    assumed pods, and queue depths, plus the flight-recorder ring (the
    postmortem view: which ladder tier served recent cycles, their span
    timings, any fallback/retry/breaker activity)."""
    cache = scheduler.cache
    lines: List[str] = ["Dump of cached NodeInfo:"]
    for nd in cache.nodes():
        pods = cache.pods_on(nd.name)
        cpu = sum(p.requests.cpu_milli for p in pods)
        mem = sum(p.requests.memory for p in pods)
        lines.append(
            f"  node {nd.name}: pods={len(pods)} "
            f"req_cpu={cpu:.0f}m/{nd.allocatable.cpu_milli:.0f}m "
            f"req_mem={mem:.0f}/{nd.allocatable.memory:.0f}"
        )
        for p in pods:
            state = "assumed" if cache.is_assumed(p.key()) else "added"
            lines.append(f"    pod {p.key()} [{state}] prio={p.priority}")
    lines.append("Dump of scheduling queue:")
    for q, depth in scheduler.queue.pending_counts().items():
        lines.append(f"  {q}: {depth}")
    obs = getattr(scheduler, "obs", None)
    recorder = getattr(obs, "recorder", None)
    if recorder is not None:
        lines.append(recorder.dump())
    if obs is not None:
        memledger = getattr(obs, "memledger", None)
        if memledger is not None and memledger.enabled:
            # the device-memory view of the same postmortem: ranked
            # residents, watermarks, preflight verdicts, OOM forensics
            lines.append(memledger.dump())
        incidents = getattr(obs, "incidents", None)
        if incidents is not None and incidents.enabled:
            # the correlated-incident view: one line per captured
            # bundle, pointing the postmortem at /debug/incidents
            lines.append(incidents.dump())
    return "\n".join(lines)


def compare(
    scheduler, truth_pods: Dict[str, str], truth_nodes: List[str]
) -> Tuple[List[str], List[str]]:
    """comparer.go:48 CompareNodes/ComparePods: returns (node_diffs,
    pod_diffs) between the cache and the source of truth. ``truth_pods``
    maps pod key -> bound node name ("" = pending); ``truth_nodes`` lists
    live node names. Assumed-but-not-yet-confirmed pods are cache-only by
    design and NOT reported (the reference compares against the nodeinfo
    snapshot the same way: assumed pods are in both)."""
    cache = scheduler.cache
    cached_nodes = {nd.name for nd in cache.nodes()}
    node_diffs = sorted(cached_nodes ^ set(truth_nodes))

    cached: Dict[str, str] = {}
    for nd in cache.nodes():
        for p in cache.pods_on(nd.name):
            cached[p.key()] = nd.name
    pod_diffs: List[str] = []
    bound_truth = {k: n for k, n in truth_pods.items() if n}
    for key, node in bound_truth.items():
        got = cached.get(key)
        if got is None:
            pod_diffs.append(f"{key}: bound to {node} but missing from cache")
        elif got != node:
            pod_diffs.append(f"{key}: cache says {got}, truth says {node}")
    for key, node in cached.items():
        if key not in bound_truth and not cache.is_assumed(key):
            pod_diffs.append(f"{key}: in cache on {node} but not bound in truth")
    return node_diffs, sorted(pod_diffs)


def install_signal_handler(scheduler, sig=signal.SIGUSR2) -> None:
    """debugger.go:29 — SIGUSR2 prints the dump (via the trace logger)."""
    import logging

    log = logging.getLogger("kubernetes_tpu_torch.debugger")

    def handler(signum, frame):
        log.info(dump(scheduler))

    signal.signal(sig, handler)
