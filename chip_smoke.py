"""Chip smoke test for the PyTorch/CUDA port (``kubernetes_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``kubernetes_tpu_torch/csrc`` (one
``nvcc`` per source, in parallel), then runs five phases and exits non-zero
if any fails:

1. environment: card name and power limit, torch/CUDA versions, build time;
2. every kernel against its plain PyTorch version on the card, at the main
   path's shape (8192 x 8192) and a ragged one (5000 x 3000), with times;
3. the main path at full width, cell ``smoke-5k-prefaffinity``: 5000
   nodes, 1000 bound pods, 10,000 pending pods with preferred zone
   affinity and a PreferNoSchedule taint on every 10th node, through
   ``Scheduler(device="cuda")`` until the queue drains;
4. the plan path: ``Scheduler(solver="sinkhorn")`` on the same cluster
   with 4096 pending pods, then the tied-preferences workload through
   the default auto-router;
5. one reduced cycle (1000 nodes x 2048 pods) on CUDA and on CPU tensors
   (the plain versions) must place identically.

Lines of JSON report each phase; the line before the last lists every
kernel with its launches on the main paths (the smoke cell and the plan
path, each counted from 0 just before it runs: ``launches`` is their sum,
``launches_by_path`` and ``launches_per_cycle`` split it), error against
the plain version, times and bound; the last line is the one-line contract
``{"ok": true, "device": {...}}``. Without a CUDA card it exits non-zero
and prints no result. ``--phases`` runs a subset (comma-separated names:
env, kernels, smoke, plan, parity); ``--profile DIR`` adds one profiled
cycle of the smoke cell (device time by kernel, a trace written to DIR).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM data-sheet peaks (NVIDIA): HBM3 bytes/s and f32 (non-tensor)
#: operations/s, for each kernel's least possible time
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12

ALL_PHASES = ("env", "kernels", "smoke", "plan", "parity")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_time_ms(fn, warmup: int = 3, reps: int = 15) -> float:
    """Median milliseconds of one ``fn()`` on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

KERNELS = {
    "fused_pair_normalize": {
        "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/fused_pair.cu",
        "replaces": "kubernetes_tpu/ops/fused_score.py:75 _pair_max_kernel"
                    " + :95 _pair_scale_kernel",
    },
    "sinkhorn_u": {
        "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/sinkhorn.cu",
        "replaces": "kubernetes_tpu/ops/sinkhorn.py:156 _u_kernel",
    },
    "sinkhorn_v": {
        "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/sinkhorn.cu",
        "replaces": "kubernetes_tpu/ops/sinkhorn.py:171 _v_kernel",
    },
}

#: Sinkhorn passes sum in another order than the plain versions
SINKHORN_ATOL, SINKHORN_RTOL = 1e-5, 1e-4


def _pair_inputs(P, N, gen, dev):
    import torch

    # the main path's raw scores: NodeAffinity weight sums (0 or 50 on
    # the smoke cell; wider here) and intolerable-taint counts (0 or 1)
    rf = (torch.randint(0, 4, (P, N), generator=gen, device=dev)
          * 50).to(torch.float32)
    rr = torch.randint(0, 2, (P, N), generator=gen,
                       device=dev).to(torch.float32)
    mask = torch.rand((P, N), generator=gen, device=dev) > 0.1
    mask[0] = False  # an all-infeasible row: both maxima 0
    return rf, rr, mask


def _sinkhorn_inputs(P, N, gen, dev):
    import torch

    from kubernetes_tpu_torch.ops.sinkhorn import NEG_INF

    score = -torch.randint(0, 40, (P, N), generator=gen,
                           device=dev).to(torch.float32)
    mask = torch.rand((P, N), generator=gen, device=dev) > 0.2
    mask[1] = False
    logk = torch.where(mask, score / 0.5, NEG_INF).contiguous()
    log_r = torch.where(mask.any(1), 0.0, NEG_INF)
    cap = torch.randint(0, 8, (N,), generator=gen, device=dev).float()
    log_c = torch.where(cap > 0, torch.log(cap.clamp_min(1e-30)), NEG_INF)
    u = -torch.rand((P,), generator=gen, device=dev) * 3
    v = -torch.rand((N,), generator=gen, device=dev) * 3
    return logk, log_r, log_c, u, v


def check_kernels(out_rows: dict) -> None:
    import torch

    from kubernetes_tpu_torch.ops import fused_score, sinkhorn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261017)
    for P, N, main in ((8192, 8192, True), (5000, 3000, False)):
        # -- fused pair: bit-identical ----------------------------------
        rf, rr, mask = _pair_inputs(P, N, gen, dev)
        got = fused_score.fused_pair_normalize(rf, rr, mask, 1.0, 1.0)
        want = fused_score.fused_pair_normalize_plain(rf, rr, mask, 1.0, 1.0)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            fail(f"fused_pair_normalize {P}x{N}: max |err| {err}, must be 0")
        row = out_rows.setdefault("fused_pair_normalize", {})
        row[f"max_abs_err_{P}x{N}"] = err
        if main:
            row["max_abs_err"] = err
            row["ms"] = cuda_time_ms(lambda: fused_score.fused_pair_normalize(
                rf, rr, mask, 1.0, 1.0))
            row["plain_ms"] = cuda_time_ms(
                lambda: fused_score.fused_pair_normalize_plain(
                    rf, rr, mask, 1.0, 1.0))
            # no single PyTorch call computes the weighted pair
            row["library_ms"] = None
            nbytes = P * N * (4 + 4 + 1 + 4)
            ops = P * N * 14  # 2 masked max, 2x(mul, div, add, floor), combine
            row.update(_bound(nbytes, ops))
        del rf, rr, mask, got, want
        # -- sinkhorn u / v: within tolerance -----------------------------
        logk, log_r, log_c, u, v = _sinkhorn_inputs(P, N, gen, dev)
        for name, kern, plain, args, lib in (
                ("sinkhorn_u", sinkhorn.sinkhorn_u, sinkhorn.sinkhorn_u_plain,
                 (logk, v, log_r),
                 lambda: torch.logsumexp(logk + v[None, :], 1)),
                ("sinkhorn_v", sinkhorn.sinkhorn_v, sinkhorn.sinkhorn_v_plain,
                 (logk, u, log_c),
                 lambda: torch.logsumexp(logk + u[:, None], 0))):
            got = kern(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not torch.allclose(got, want, atol=SINKHORN_ATOL,
                                  rtol=SINKHORN_RTOL):
                fail(f"{name} {P}x{N}: max |err| {err} beyond atol "
                     f"{SINKHORN_ATOL} rtol {SINKHORN_RTOL}")
            row = out_rows.setdefault(name, {})
            row[f"max_abs_err_{P}x{N}"] = err
            if main:
                row["max_abs_err"] = err
                row["ms"] = cuda_time_ms(lambda: kern(*args))
                row["plain_ms"] = cuda_time_ms(lambda: plain(*args))
                row["library_ms"] = cuda_time_ms(lib)
                nbytes = P * N * 4 + (P + 2 * N) * 4 if name == "sinkhorn_v" \
                    else P * N * 4 + (2 * P + N) * 4
                ops = P * N * 5  # add, max, sub, exp, sum
                row.update(_bound(nbytes, ops))
        del logk, log_r, log_c, u, v
        torch.cuda.empty_cache()
    # the kernels read rows as 16-byte vectors: a row length that is not
    # a multiple of four is refused, never read past its end
    rf, rr, mask = _pair_inputs(4, 3001, gen, dev)
    logk, log_r, _log_c, _u, v = _sinkhorn_inputs(4, 3001, gen, dev)
    for name, call in (
            ("fused_pair_normalize", lambda: fused_score.fused_pair_normalize(
                rf, rr, mask, 1.0, 1.0)),
            ("sinkhorn_u", lambda: sinkhorn.sinkhorn_u(logk, v, log_r))):
        try:
            call()
        except ValueError:
            continue
        fail(f"{name}: a row of 3001 was not refused")


def _bound(nbytes: float, ops: float) -> dict:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / F32_OPS_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


# ---------------------------------------------------------------------------
# phases 3-5: the main path through the port's Scheduler
# ---------------------------------------------------------------------------

ZONE = "failure-domain.beta.kubernetes.io/zone"
SOFT_TAINT = "DeletionCandidateOfClusterAutoscaler"


def smoke_cell(n_nodes=5000, n_bound=1000, n_pending=10000, seed=7):
    """Cell ``smoke-5k-prefaffinity``: scheduler_perf's node shape
    (4 CPU / 32 Gi / 110 pods, scheduler_test.go:49) at
    BenchmarkSchedulingNodeAffinity's scale, 10 zones; every 10th node
    carries the cluster-autoscaler's PreferNoSchedule taint and half the
    pending pods tolerate it; each pending pod (100m / 500 Mi) prefers one
    seeded random zone with weight 50. Returns (nodes, bound, pending)."""
    import random

    from kubernetes_tpu_torch.api.types import Taint, Toleration
    from kubernetes_tpu_torch.testing import (
        make_node,
        make_pod,
        node_affinity_preferred,
        req,
    )

    rng = random.Random(seed)
    taint = Taint(SOFT_TAINT, "true", "PreferNoSchedule")
    nodes = [make_node(f"node-{i}", cpu_milli=4000, memory=32 * 2**30,
                       pods=110, zone=f"zone-{i % 10}",
                       taints=(taint,) if i % 10 == 0 else ())
             for i in range(n_nodes)]
    bound = [make_pod(f"bound-{i}", cpu_milli=100, memory=500 * 2**20,
                      node_name=f"node-{i % n_nodes}")
             for i in range(n_bound)]
    tol = (Toleration(key=SOFT_TAINT, operator="Exists",
                      effect="PreferNoSchedule"),)
    pending = [make_pod(
        f"pod-{i}", cpu_milli=100, memory=500 * 2**20,
        affinity=node_affinity_preferred(
            (50, [req(ZONE, "In", f"zone-{rng.randrange(10)}")])),
        tolerations=tol if i % 2 else ())
        for i in range(n_pending)]
    return nodes, bound, pending


def drive(sched, nodes, bound, pending, max_cycles=16):
    """Feed a cluster to a scheduler and run cycles until the queue
    drains; returns the per-cycle results."""
    for nd in nodes:
        sched.on_node_add(nd)
    for p in bound:
        sched.on_pod_add(p)
    for p in pending:
        sched.on_pod_add(p)
    out = []
    for _ in range(max_cycles):
        r = sched.schedule_cycle()
        if r.attempted == 0:
            break
        out.append(r)
    return out


def recheck_capacity(nodes, bound, assignments, pods_by_key):
    """Host re-check, independent of the port: no node holds more cpu,
    memory or pods than it has."""
    used = {nd.name: [0.0, 0.0, 0] for nd in nodes}
    for p in bound:
        u = used[p.node_name]
        u[0] += p.requests.cpu_milli
        u[1] += p.requests.memory
        u[2] += 1
    for key, node in assignments.items():
        p = pods_by_key[key]
        u = used[node]
        u[0] += p.requests.cpu_milli
        u[1] += p.requests.memory
        u[2] += 1
    for nd in nodes:
        u = used[nd.name]
        a = nd.allocatable
        if u[0] > a.cpu_milli or u[1] > a.memory or u[2] > a.pods:
            fail(f"node {nd.name} over capacity: {u} > "
                 f"({a.cpu_milli}, {a.memory}, {a.pods})")


def warm_up() -> None:
    """Warm the CUDA libraries (cuBLAS handles, allocator) off the clock
    with a small cluster through the same path."""
    from kubernetes_tpu_torch.scheduler import Scheduler

    drive(Scheduler(device="cuda"),
          *smoke_cell(n_nodes=100, n_bound=20, n_pending=256, seed=1))


def phase_smoke() -> dict:
    """Returns the kernel launches of the smoke cell's run and its cycle
    count."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.scheduler import Scheduler

    warm_up()
    nodes, bound, pending = smoke_cell()
    sched = Scheduler(device="cuda")
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = drive(sched, nodes, bound, pending)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    scheduled = sum(r.scheduled for r in results)
    if scheduled != len(pending):
        fail(f"smoke: bound {scheduled} of {len(pending)} pods")
    for r in results:
        # a failed kernel must not pass through the greedy tier
        if r.solver_tier != "batch" or r.solver_fallbacks:
            fail(f"smoke: a cycle solved on tier {r.solver_tier!r} after "
                 f"{r.solver_fallbacks} fallbacks")
    if launches["fused_pair_normalize"] <= 0:
        fail("smoke: the fused-pair kernel was never launched")
    assignments = {}
    for r in results:
        assignments.update(r.assignments)
    recheck_capacity(nodes, bound, assignments,
                     {p.key(): p for p in pending})
    cycle_s = sum(r.elapsed_s for r in results)
    emit({"phase": "smoke", "cell": "smoke-5k-prefaffinity",
          "nodes": len(nodes), "bound": len(bound),
          "pending": len(pending), "scheduled": scheduled,
          "cycles": len(results),
          "cycle_s": [r.elapsed_s for r in results],
          "solve_s": [r.solve_s for r in results],
          "rounds": [r.rounds for r in results],
          "host_syncs": [r.host_syncs for r in results],
          "snapshot_mode": [r.snapshot_mode for r in results],
          "pods_per_s_cycles": scheduled / cycle_s,
          "pods_per_s_wall_with_ingest": scheduled / wall,
          "wall_s_with_ingest": wall, "launches": launches,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    return {"launches": launches, "cycles": len(results)}


def tied_preferences_workload(n_hot=4, n_cold=20, n_steep=16, n_flat=80):
    """Steep pods (hot=10, cold=0) tie with flat pods (hot=10, cold=9) on
    scarce hot nodes, flat pods listed first (the construction of
    tests/test_sinkhorn.py:182). Returns (nodes, pods, points_fn)."""
    from kubernetes_tpu_torch.api.types import (
        Affinity,
        Node,
        NodeSelectorTerm,
        Pod,
        PreferredSchedulingTerm,
        Requirement,
        Resources,
    )

    def node(name, zone):
        return Node(name=name,
                    allocatable=Resources(cpu_milli=4000,
                                          memory=32 * 2**30, pods=110),
                    labels={"kubernetes.io/hostname": name, ZONE: zone})

    def prefer(*weight_zone):
        return Affinity(node_preferred=tuple(
            PreferredSchedulingTerm(
                weight=w,
                preference=NodeSelectorTerm(
                    (Requirement(ZONE, "In", (z,)),)))
            for w, z in weight_zone))

    nodes = [node(f"hot{i}", "hot") for i in range(n_hot)] + [
        node(f"cold{i}", "cold") for i in range(n_cold)]
    pods = [Pod(name=f"flat{i}",
                requests=Resources(cpu_milli=900, memory=2**30),
                affinity=prefer((10, "hot"), (9, "cold")))
            for i in range(n_flat)]
    pods += [Pod(name=f"steep{i}",
                 requests=Resources(cpu_milli=900, memory=2**30),
                 affinity=prefer((10, "hot")))
             for i in range(n_steep)]

    def points(assigned):
        total = 0
        for i, p in enumerate(pods):
            if assigned[i] < 0:
                continue
            on_hot = int(assigned[i]) < n_hot
            total += (10 if on_hot else 0) if p.name.startswith("steep") \
                else (10 if on_hot else 9)
        return total

    return nodes, pods, points


def phase_plan() -> dict:
    """Returns the kernel launches of the plan path's run and its cycle
    count (the tied-preferences check after it is not counted)."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.ops.arrays import (
        nodes_to_device,
        pods_to_device,
        selectors_to_device,
    )
    from kubernetes_tpu_torch.ops.assign import batch_assign
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.snapshot import SnapshotPacker

    nodes, bound, pending = smoke_cell(n_pending=4096)
    sched = Scheduler(solver="sinkhorn", device="cuda")
    kernels.reset_launches()
    results = drive(sched, nodes, bound, pending)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if launches["sinkhorn_u"] <= 0 or launches["sinkhorn_v"] <= 0:
        fail(f"plan: Sinkhorn kernels not launched ({launches})")
    assignments = {}
    for r in results:
        assignments.update(r.assignments)
        if r.solver_tier != "sinkhorn" or r.solver_fallbacks:
            fail(f"plan: a cycle solved on tier {r.solver_tier!r} after "
                 f"{r.solver_fallbacks} fallbacks")
    recheck_capacity(nodes, bound, assignments,
                     {p.key(): p for p in pending})
    emit({"phase": "plan", "solver": "sinkhorn", "nodes": len(nodes),
          "pending": len(pending), "scheduled": len(assignments),
          "cycle_s": [r.elapsed_s for r in results],
          "rounds": [r.rounds for r in results],
          "host_syncs": [r.host_syncs for r in results],
          "launches": launches})

    # the tied-preferences workload through the DEFAULT auto-router
    t_nodes, t_pods, points = tied_preferences_workload()
    pk = SnapshotPacker()
    for p in t_pods:
        pk.intern_pod(p)
    dev = "cuda"
    dn = nodes_to_device(pk.pack_nodes(t_nodes, []), device=dev)
    dp = pods_to_device(pk.pack_pods(t_pods), device=dev)
    ds = selectors_to_device(pk.pack_selector_tables(), device=dev)
    quality = {}
    for label, kw in (("default", {}),
                      ("argmax_only", {"auto_sinkhorn": False}),
                      ("forced_plan", {"use_sinkhorn": True})):
        kernels.reset_launches()
        a, _, _ = batch_assign(dp, dn, ds, per_node_cap=2, **kw)
        torch.cuda.synchronize()
        got = dict(kernels.LAUNCHES)
        if label == "default":
            if got["sinkhorn_u"] <= 0:
                fail("tied: the auto-router did not route to the plan")
        host = a.cpu().numpy()[: len(t_pods)]
        if int((host >= 0).sum()) != len(t_pods):
            fail(f"tied/{label}: placed {(host >= 0).sum()} of {len(t_pods)}")
        quality[label] = points(host)
    if not (quality["default"] == quality["forced_plan"]
            > quality["argmax_only"]):
        fail(f"tied: auto-router quality {quality}")
    emit({"phase": "plan-tied", "quality_points": quality})
    return {"launches": launches, "cycles": len(results)}


def profile_cycle(out_dir: str) -> None:
    """One cycle of the smoke cell under torch.profiler: device time by
    kernel, the device-busy share of the cycle, and a gzipped Chrome trace
    in ``out_dir`` (``--profile`` only; the timed runs are unprofiled)."""
    import gzip

    import torch
    from torch.profiler import ProfilerActivity, profile

    from kubernetes_tpu_torch.scheduler import Scheduler

    warm_up()
    nodes, bound, pending = smoke_cell()
    sched = Scheduler(device="cuda")
    for nd in nodes:
        sched.on_node_add(nd)
    for p in bound + pending:
        sched.on_pod_add(p)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = sched.schedule_cycle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    os.makedirs(out_dir, exist_ok=True)
    trace = os.path.join(out_dir, "smoke_cycle_trace.json")
    prof.export_chrome_trace(trace)
    with open(trace, "rb") as src:
        raw = src.read()
    with gzip.open(trace + ".gz", "wb") as dst:
        dst.write(raw)
    os.remove(trace)
    # device time: the union of the intervals of the events that ran on
    # the card (kernels, copies, fills) -- never the host-side ATen ops,
    # which carry their kernels' time a second time
    dev_events = [e for e in json.loads(raw).get("traceEvents", [])
                  if e.get("ph") == "X" and e.get("cat") in
                  ("kernel", "gpu_memcpy", "gpu_memset")]
    busy_us, end = 0.0, float("-inf")
    for e in sorted(dev_events, key=lambda e: float(e["ts"])):
        t0_us, t1_us = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        busy_us += max(0.0, t1_us - max(t0_us, end))
        end = max(end, t1_us)
    by_name: dict = {}
    for e in dev_events:
        c = by_name.setdefault(e["name"][:80], [0, 0.0])
        c[0] += 1
        c[1] += float(e["dur"])
    top = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)[:15]
    emit({"phase": "profile", "cell": "smoke-5k-prefaffinity",
          "cycle": 1, "scheduled": r.scheduled, "rounds": r.rounds,
          "wall_s_profiled": wall, "solve_s": r.solve_s,
          "device_events": len(dev_events),
          "device_busy_s": busy_us / 1e6,
          "device_busy_share": busy_us / 1e6 / wall,
          "top_device_ops": [{"name": k, "count": c, "device_ms": us / 1e3}
                             for k, (c, us) in top]})
    if not dev_events:
        fail("profile: the trace holds no device events")


def phase_parity() -> None:
    """One reduced cycle on CUDA (kernels) and on CPU tensors (plain
    versions): placements must be identical."""
    from kubernetes_tpu_torch.scheduler import Scheduler

    out = {}
    for dev in ("cuda", "cpu"):
        nodes, bound, pending = smoke_cell(n_nodes=1000, n_bound=200,
                                           n_pending=2048, seed=11)
        r = drive(Scheduler(device=dev), nodes, bound, pending, max_cycles=1)
        out[dev] = r[0]
    a, b = out["cuda"], out["cpu"]
    if a.assignments != b.assignments or a.rounds != b.rounds:
        diff = sum(1 for k in a.assignments
                   if b.assignments.get(k) != a.assignments[k])
        fail(f"parity: CUDA and CPU placements differ ({diff} pods, "
             f"rounds {a.rounds} vs {b.rounds})")
    emit({"phase": "parity", "nodes": 1000, "pending": 2048,
          "scheduled": a.scheduled, "rounds": a.rounds,
          "identical": True})


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def gpu_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable: {e}"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES))
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one smoke-cell cycle, trace into DIR")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    for p in phases:
        if p not in ALL_PHASES:
            ap.error(f"unknown phase {p!r}")

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the smoke test needs a "
             "CUDA card")
    sys.path.insert(0, HERE)
    from kubernetes_tpu_torch import kernels

    smi = gpu_line()
    t0 = time.perf_counter()
    reports = kernels.build()
    build_s = time.perf_counter() - t0
    if "env" in phases:
        emit({"phase": "env", "nvidia_smi": smi,
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "python": sys.version.split()[0],
              "device": torch.cuda.get_device_name(0),
              "kernel_build_s": build_s,
              "ptxas": {k: [ln for ln in v.splitlines()
                            if "registers" in ln or "spill" in ln]
                        for k, v in reports.items()}})

    rows: dict = {}
    if "kernels" in phases:
        check_kernels(rows)
        emit({"phase": "kernels", "ok": True})

    paths = {}
    if "smoke" in phases:
        paths["smoke"] = phase_smoke()
    if "plan" in phases:
        paths["plan"] = phase_plan()
    if "parity" in phases:
        phase_parity()
    if args.profile:
        profile_cycle(args.profile)
    out = []
    for name, meta in KERNELS.items():
        r = dict(name=name, **meta)
        r.update(rows.get(name, {}))
        by_path = {p: got["launches"][name] for p, got in paths.items()}
        r["launches"] = sum(by_path.values())
        r["launches_by_path"] = by_path
        r["launches_per_cycle"] = {p: got["launches"][name] / got["cycles"]
                                   for p, got in paths.items()}
        if len(paths) == 2 and r["launches"] <= 0:
            fail(f"kernel {name} was never launched on the main paths")
        out.append(r)
    emit({"kernels": out})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
