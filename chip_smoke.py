"""Chip smoke test for the PyTorch/CUDA port (``kubernetes_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``kubernetes_tpu_torch/csrc`` (one
``nvcc`` per source, in parallel), then runs seven phases and exits
non-zero if any fails:

1. environment: card name and power limit, torch/CUDA versions, build time,
   each kernel function's registers, shared memory and spills (ptxas);
2. every kernel against its plain PyTorch version on the card, at the main
   path's padded shape (8192 x 8192) and a ragged one (5000 x 3000); the
   fused pair also on the widest staged row (1024 x 12288), a row past the
   staged limit (256 x 16384) and the smallest bucket (64 x 8), each on
   the path its route names; the v pass also at 1000 x 3001, and twice
   to the same bits. Times at 8192 x 8192 (the pair's wide path beside its
   staged one) and, once the main paths ran, the pair and the v pass held
   again and timed at the shapes those paths launched;
3. the main path at full width, cell ``smoke-5k-prefaffinity``: 5000
   nodes, 1000 bound pods, 10,000 pending pods with preferred zone
   affinity and a PreferNoSchedule taint on every 10th node, through
   ``Scheduler(device="cuda")`` until the queue drains;
4. the plan path: ``Scheduler(solver="sinkhorn")`` on the same cluster
   with 4096 pending pods, then the tied-preferences workload through
   the default auto-router;
5. the topology path at full width, cell ``topo-5k-mixed``: the same
   cluster with 10,000 pending pods mixing preferred zones, hostname pod
   anti-affinity, zone pod affinity, and hard and soft topology spread,
   checked by a host re-check of every constraint;
6. one reduced cycle of each cell (1000 nodes x 2048 pods) on CUDA and on
   CPU tensors (the plain versions) must place identically;
7. the failure path at full width, cell ``preempt-5k-burst``: 5000 full
   nodes (20,000 bound low-priority pods, some under a PDB) take 4064
   ordinary pods and 32 high-priority preemptors, then 64 poachers that
   only the freed nodes could hold, on a hand-advanced clock: preemption,
   nominated pods (pass A) and the explain report, checked by a host
   re-check of every victim, nomination, poacher and node.

Lines of JSON report each phase; the line before the last lists every
kernel with its launches on the main paths (the smoke cell, the plan
path, the topology path and the preempt cell, each counted from 0 just
before it runs: ``launches`` is their sum, ``launches_by_path`` and
``launches_per_cycle`` split it), error against the plain version, times
and bound (``ms``, ``plain_ms`` and ``library_ms`` are single-call
CUDA-event medians; ``ms_batched`` times back-to-back calls and
``device_ms`` is the trace's device time); the last line is the one-line
contract
``{"ok": true, "device": {...}}``. Without a CUDA card it exits non-zero
and prints no result. ``--phases`` runs a subset (comma-separated names:
env, kernels, smoke, plan, topology, parity, preempt); ``--profile DIR``
adds one profiled first cycle of the smoke cell and of the topology cell
(device time by kernel, traces written to DIR).
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

ALL_PHASES = ("env", "kernels", "smoke", "plan", "topology", "parity",
              "preempt")
#: the phases that drive a main path and count its kernel launches
MAIN_PATHS = ("smoke", "plan", "topology", "preempt")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_time_ms(fn, warmup: int = 3, reps: int = 15,
                 batch: int = 1) -> float:
    """Median milliseconds of one ``fn()`` on the card (CUDA events around
    ``batch`` back-to-back calls, divided by ``batch``: with ``batch`` > 1
    the host enqueues ahead and its own time per call drops out)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def batched_ms(fn) -> float:
    """Milliseconds of one call in 10 windows of 10 back-to-back calls
    (the host's time per call hides behind the card's when it is the
    shorter; ``ms`` in the kernels line is the single-call median of
    :func:`cuda_time_ms`, the method of every earlier reading)."""
    return cuda_time_ms(fn, reps=10, batch=10)


def device_ms(fn, reps: int = 10) -> dict:
    """Device time of ``fn()`` from torch.profiler's CUPTI trace of
    ``reps`` calls: ``by_kernel``, the mean over each kernel's (or copy's,
    or memset's) launches with their count, and ``per_call``, the sum of
    each one's mean times its launches a call (its count over ``reps``,
    rounded, at least 1: the trace can miss a call's events) -- the
    card's own time for the work, without the host's launch gaps.
    ``per_call`` is None when the trace holds no device events."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    got: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = re.sub(r"\(anonymous namespace\)::|^void ", "", e.name)
        name = name.split("(")[0].strip()[:60]
        t, c = got.get(name, (0.0, 0))
        got[name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    return {"per_call": (sum(t / c * max(1, round(c / reps))
                             for t, c in got.values()) if got else None),
            "by_kernel": {k: {"ms": t / c, "count": c}
                          for k, (t, c) in got.items()}}


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


#: shapes the pair is held bit for bit at: the main path's padded shape
#: (staged, timed), a ragged one (3000 % 16 != 0: wide), the widest staged
#: row, a row wider than the staged limit and the smallest bucket (wide)
PAIR_SHAPES = ((8192, 8192), (5000, 3000), (1024, 12288), (256, 16384),
               (64, 8))
#: shapes the Sinkhorn passes are held at: the padded main shape (timed),
#: a ragged one, and a row that is not a multiple of four (v only: the u
#: pass refuses it)
SINKHORN_SHAPES = ((8192, 8192), (5000, 3000), (1000, 3001))


def _pair_bound(P, N) -> dict:
    nbytes = P * N * (4 + 4 + 1 + 4)
    ops = P * N * 14  # 2 masked max, 2x(mul, div, add, floor), combine
    return _bound(nbytes, ops)


def _sinkhorn_bound(name, P, N) -> dict:
    nbytes = P * N * 4 + (P + 2 * N) * 4 if name == "sinkhorn_v" \
        else P * N * 4 + (2 * P + N) * 4
    ops = P * N * 5  # add, max, sub, exp, sum
    return _bound(nbytes, ops)


def time_pair(P, N, gen, dev) -> dict:
    """The pair's wrapper and plain version timed at (P, N), the wrapper
    held bit for bit against the plain version on the same inputs."""
    import torch

    from kubernetes_tpu_torch.ops import fused_score

    rf, rr, mask = _pair_inputs(P, N, gen, dev)

    def kern():
        return fused_score.fused_pair_normalize(rf, rr, mask, 1.0, 1.0)

    def plain():
        return fused_score.fused_pair_normalize_plain(rf, rr, mask, 1.0,
                                                      1.0)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        fail(f"fused_pair_normalize {P}x{N}: max |err| {err}, must be 0")
    out = {"max_abs_err": err, "ms": cuda_time_ms(kern),
           "ms_batched": batched_ms(kern), "device_ms": device_ms(kern),
           "plain_ms": cuda_time_ms(plain)}
    out.update(_pair_bound(P, N))
    return out


def time_v(P, N, gen, dev) -> dict:
    """The v pass's wrapper, plain version and library call timed at
    (P, N), the wrapper held against the plain version on the same inputs
    within the stated tolerance."""
    import torch

    from kubernetes_tpu_torch.ops import sinkhorn

    logk, _log_r, log_c, u, _v = _sinkhorn_inputs(P, N, gen, dev)

    def kern():
        return sinkhorn.sinkhorn_v(logk, u, log_c)

    def plain():
        return sinkhorn.sinkhorn_v_plain(logk, u, log_c)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=SINKHORN_ATOL, rtol=SINKHORN_RTOL):
        fail(f"sinkhorn_v {P}x{N}: max |err| {err} beyond atol "
             f"{SINKHORN_ATOL} rtol {SINKHORN_RTOL}")
    out = {"max_abs_err": err, "ms": cuda_time_ms(kern),
           "ms_batched": batched_ms(kern), "device_ms": device_ms(kern),
           "plain_ms": cuda_time_ms(plain),
           "library_ms": cuda_time_ms(
               lambda: torch.logsumexp(logk + u[:, None], 0))}
    out.update(_sinkhorn_bound("sinkhorn_v", P, N))
    return out


def _wide_pair(rf, rr, mask):
    """The pair's wide path launched directly, whatever the row (a timing
    yardstick for the staged path; not a launch of the main path)."""
    import torch

    from kubernetes_tpu_torch.ops import fused_score

    out = torch.empty_like(rf)
    fused_score.launch(rf, rr, mask, out, 1.0, 1.0, staged=False)
    return out


def check_kernels(out_rows: dict) -> None:
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.ops import fused_score, sinkhorn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261017)
    row = out_rows.setdefault("fused_pair_normalize", {})
    for i, (P, N) in enumerate(PAIR_SHAPES):
        # -- fused pair: bit-identical on both paths --------------------
        rf, rr, mask = _pair_inputs(P, N, gen, dev)
        wide0 = kernels.LAUNCHES["fused_pair_normalize_wide"]
        got = fused_score.fused_pair_normalize(rf, rr, mask, 1.0, 1.0)
        path = ("wide" if kernels.LAUNCHES["fused_pair_normalize_wide"]
                > wide0 else "staged")
        want = fused_score.fused_pair_normalize_plain(rf, rr, mask, 1.0, 1.0)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            fail(f"fused_pair_normalize {P}x{N} ({path}): max |err| {err}, "
                 "must be 0")
        want_path = ("staged" if fused_score.staged_route(N, rf, rr, mask,
                                                          got) else "wide")
        if path != want_path:
            fail(f"fused_pair_normalize {P}x{N}: took the {path} path, "
                 f"route says {want_path}")
        row[f"max_abs_err_{P}x{N}_{path}"] = err
        if i == 0:
            if path != "staged":
                fail(f"fused_pair_normalize {P}x{N}: the main shape took "
                     "the wide path")
            row["max_abs_err"] = err

            def kern():
                return fused_score.fused_pair_normalize(rf, rr, mask, 1.0,
                                                        1.0)

            row["ms"] = cuda_time_ms(kern)
            row["ms_batched"] = batched_ms(kern)
            row["device_ms"] = device_ms(kern)
            row["wide_ms"] = cuda_time_ms(lambda: _wide_pair(rf, rr, mask))
            row["wide_ms_batched"] = batched_ms(
                lambda: _wide_pair(rf, rr, mask))
            row["wide_device_ms"] = device_ms(lambda: _wide_pair(rf, rr,
                                                                 mask))
            if not torch.equal(_wide_pair(rf, rr, mask), want):
                fail(f"fused_pair_normalize {P}x{N}: the wide path differs")
            row["plain_ms"] = cuda_time_ms(
                lambda: fused_score.fused_pair_normalize_plain(
                    rf, rr, mask, 1.0, 1.0))
            # no single PyTorch call computes the weighted pair
            row["library_ms"] = None
            row.update(_pair_bound(P, N))
        del rf, rr, mask, got, want
        torch.cuda.empty_cache()
    for i, (P, N) in enumerate(SINKHORN_SHAPES):
        # -- sinkhorn u / v: within tolerance -----------------------------
        logk, log_r, log_c, u, v = _sinkhorn_inputs(P, N, gen, dev)
        for name, kern, plain, args, lib in (
                ("sinkhorn_u", sinkhorn.sinkhorn_u, sinkhorn.sinkhorn_u_plain,
                 (logk, v, log_r),
                 lambda: torch.logsumexp(logk + v[None, :], 1)),
                ("sinkhorn_v", sinkhorn.sinkhorn_v, sinkhorn.sinkhorn_v_plain,
                 (logk, u, log_c),
                 lambda: torch.logsumexp(logk + u[:, None], 0))):
            if name == "sinkhorn_u" and N % 4:
                continue
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
            if i == 0:
                row["max_abs_err"] = err
                row["ms"] = cuda_time_ms(lambda: kern(*args))
                row["ms_batched"] = batched_ms(lambda: kern(*args))
                row["device_ms"] = device_ms(lambda: kern(*args))
                row["plain_ms"] = cuda_time_ms(lambda: plain(*args))
                row["library_ms"] = cuda_time_ms(lib)
                row.update(_sinkhorn_bound(name, P, N))
        # the v pass gives the same bits run to run (the last block of a
        # strip merges the chunk partials in chunk order)
        if not torch.equal(sinkhorn.sinkhorn_v(logk, u, log_c),
                           sinkhorn.sinkhorn_v(logk, u, log_c)):
            fail(f"sinkhorn_v {P}x{N}: two runs differ")
        del logk, log_r, log_c, u, v
        torch.cuda.empty_cache()
    # the pair and the u pass read rows as 16-byte vectors: a row length
    # that is not a multiple of four is refused, never read past its end
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


def time_main_shapes(out_rows: dict, paths: dict) -> None:
    """Times the redesigned kernels at the shapes their main path
    launched, read off the launches: the pair at the smoke cell's first
    launch (its first cycle's batch), the v pass at the plan path's."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261018)
    for name, phase, timer in (("fused_pair_normalize", "smoke", time_pair),
                               ("sinkhorn_v", "plan", time_v)):
        shapes = paths.get(phase, {}).get("shapes", {}).get(name)
        if not shapes:
            continue
        P, N = shapes[0][0]
        got = timer(P, N, gen, dev)
        out_rows.setdefault(name, {})["main_shape"] = {
            "phase": phase, "shape": [P, N],
            "launches_by_shape": shapes, **got}
        torch.cuda.empty_cache()


def launch_shapes() -> dict:
    """Each kernel's launches since the last reset, by shape, in the
    order of each shape's first launch: ``[[[P, N], launches], ...]``."""
    from kubernetes_tpu_torch import kernels

    return {k: [[list(s), c] for s, c in v.items()]
            for k, v in kernels.SHAPES.items()}


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
HOSTNAME = "kubernetes.io/hostname"
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
    shapes = launch_shapes()
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
    return {"launches": launches, "cycles": len(results), "shapes": shapes}


def topo_cell(n_nodes=5000, n_bound=1000, n_pending=10000, seed=7,
              zones=10):
    """Cell ``topo-5k-mixed``: the smoke cell's cluster, and pending pods
    of 100m / 500 Mi interleaved by ``i % 5`` so that every cycle carries
    every kind: 0 the smoke cell's weight-50 preferred zone (tolerating
    the taint on odd ``i``); 1 required pod anti-affinity on the hostname
    against its own ``anti-group`` label (n // 50 groups over the kind's
    n pods, BenchmarkSchedulingPodAntiAffinity); 2 required pod affinity on
    the zone to its own ``aff-group`` label (n // 100 groups,
    BenchmarkSchedulingPodAffinity; each group's first pod seeds a zone
    through the self-match escape); 3 a hard hostname spread (maxSkew 1,
    DoNotSchedule); 4 a soft zone spread (ScheduleAnyway). Returns
    (nodes, bound, pending)."""
    import random

    from kubernetes_tpu_torch.api.types import (
        Affinity,
        LabelSelector,
        PodAffinityTerm,
        Taint,
        Toleration,
        TopologySpreadConstraint,
    )
    from kubernetes_tpu_torch.testing import (
        make_node,
        make_pod,
        node_affinity_preferred,
        req,
    )

    rng = random.Random(seed)
    taint = Taint(SOFT_TAINT, "true", "PreferNoSchedule")
    nodes = [make_node(f"node-{i}", cpu_milli=4000, memory=32 * 2**30,
                       pods=110, zone=f"zone-{i % zones}",
                       taints=(taint,) if i % 10 == 0 else ())
             for i in range(n_nodes)]
    bound = [make_pod(f"bound-{i}", cpu_milli=100, memory=500 * 2**20,
                      node_name=f"node-{i % n_nodes}")
             for i in range(n_bound)]
    tol = (Toleration(key=SOFT_TAINT, operator="Exists",
                      effect="PreferNoSchedule"),)
    per_kind = n_pending // 5
    anti_groups = max(per_kind // 50, 1)
    aff_groups = max(per_kind // 100, 1)

    def term(key, labels):
        return PodAffinityTerm(
            label_selector=LabelSelector(match_labels=dict(labels)),
            topology_key=key)

    def spread(key, when, labels):
        return TopologySpreadConstraint(
            max_skew=1, topology_key=key, when_unsatisfiable=when,
            label_selector=LabelSelector(match_labels=dict(labels)))

    pending = []
    for i in range(n_pending):
        kind, j = i % 5, i // 5
        kw = {}
        if kind == 0:
            kw = dict(affinity=node_affinity_preferred(
                (50, [req(ZONE, "In", f"zone-{rng.randrange(zones)}")])),
                tolerations=tol if i % 2 else ())
        elif kind == 1:
            labels = {"anti-group": f"g{j % anti_groups}"}
            kw = dict(labels=labels, affinity=Affinity(
                pod_anti_affinity_required=(term(HOSTNAME, labels),)))
        elif kind == 2:
            labels = {"aff-group": f"g{j % aff_groups}"}
            kw = dict(labels=labels, affinity=Affinity(
                pod_affinity_required=(term(ZONE, labels),)))
        elif kind == 3:
            labels = {"spread-app": "hard"}
            kw = dict(labels=labels, topology_spread=(
                spread(HOSTNAME, "DoNotSchedule", labels),))
        else:
            labels = {"spread-app": "soft"}
            kw = dict(labels=labels, topology_spread=(
                spread(ZONE, "ScheduleAnyway", labels),))
        pending.append(make_pod(f"pod-{i}", cpu_milli=100,
                                memory=500 * 2**20, **kw))
    return nodes, bound, pending


def recheck_topology(nodes, assignments, pods_by_key) -> dict:
    """Host re-check of the topology cell, independent of the port: no
    node holds two pods of one anti-group, every affinity group lies in
    one zone, and no node holds two hard-spread pods. Returns the counts
    it checked."""
    zone_of = {nd.name: nd.labels[ZONE] for nd in nodes}
    anti, hard, aff_zones = set(), set(), {}
    for key, node in assignments.items():
        labels = pods_by_key[key].labels
        g = labels.get("anti-group")
        if g is not None:
            if (g, node) in anti:
                fail(f"topology: node {node} holds two pods of anti-group "
                     f"{g}")
            anti.add((g, node))
        if labels.get("spread-app") == "hard":
            if node in hard:
                fail(f"topology: node {node} holds two hard-spread pods")
            hard.add(node)
        g = labels.get("aff-group")
        if g is not None:
            aff_zones.setdefault(g, set()).add(zone_of[node])
    split = {g: sorted(z) for g, z in aff_zones.items() if len(z) != 1}
    if split:
        fail(f"topology: affinity groups span several zones: {split}")
    return {"anti_pods": len(anti), "hard_spread_nodes": len(hard),
            "affinity_groups": len(aff_zones)}


#: the cells that drive a main path: phase -> (cell name, builder, re-check
#: beyond capacity or None)
CELLS = {
    "smoke": ("smoke-5k-prefaffinity", smoke_cell, None),
    "topology": ("topo-5k-mixed", topo_cell, recheck_topology),
}


def warm_up(phase: str) -> None:
    """Warm the CUDA libraries (cuBLAS handles, allocator, the ATen kernels
    the path loads at first use) off the clock with a small cluster of the
    same cell through the same path."""
    from kubernetes_tpu_torch.scheduler import Scheduler

    build = CELLS[phase][1]
    drive(Scheduler(device="cuda"),
          *build(n_nodes=100, n_bound=20, n_pending=260, seed=1))


def phase_cell(phase: str) -> dict:
    """Drives the phase's cell at full width through
    ``Scheduler(device="cuda")`` until the queue drains, and fails unless
    every pod binds on tier ``batch`` with no fallback, the fused pair
    kernel launched, and the host re-checks pass. Returns the kernel
    launches of the run and its cycle count."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.scheduler import Scheduler

    cell, build, recheck = CELLS[phase]
    warm_up(phase)
    nodes, bound, pending = build()
    sched = Scheduler(device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    results = drive(sched, nodes, bound, pending)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    shapes = launch_shapes()
    scheduled = sum(r.scheduled for r in results)
    if scheduled != len(pending):
        fail(f"{phase}: bound {scheduled} of {len(pending)} pods")
    for r in results:
        # a failed kernel must not pass through the greedy tier
        if r.solver_tier != "batch" or r.solver_fallbacks:
            fail(f"{phase}: a cycle solved on tier {r.solver_tier!r} after "
                 f"{r.solver_fallbacks} fallbacks")
    if launches["fused_pair_normalize"] <= 0:
        fail(f"{phase}: the fused-pair kernel was never launched")
    assignments = {}
    for r in results:
        assignments.update(r.assignments)
    by_key = {p.key(): p for p in pending}
    recheck_capacity(nodes, bound, assignments, by_key)
    checked = recheck(nodes, assignments, by_key) if recheck else None
    cycle_s = sum(r.elapsed_s for r in results)
    emit({"phase": phase, "cell": cell,
          "nodes": len(nodes), "bound": len(bound),
          "pending": len(pending), "scheduled": scheduled,
          "cycles": len(results),
          "attempted": [r.attempted for r in results],
          "cycle_s": [r.elapsed_s for r in results],
          "solve_s": [r.solve_s for r in results],
          "rounds": [r.rounds for r in results],
          "host_syncs": [r.host_syncs for r in results],
          "snapshot_mode": [r.snapshot_mode for r in results],
          "pods_per_s_cycles": scheduled / cycle_s,
          "pods_per_s_wall_with_ingest": scheduled / wall,
          "wall_s_with_ingest": wall, "launches": launches,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "recheck": checked})
    return {"launches": launches, "cycles": len(results), "shapes": shapes}


def profile_cycle(out_dir: str, phase: str) -> None:
    """The first cycle of the phase's cell under torch.profiler: device
    time by kernel, the device-busy share of the cycle, and a gzipped
    Chrome trace in ``out_dir`` (``--profile`` only; the timed runs are
    unprofiled)."""
    import gzip

    import torch
    from torch.profiler import ProfilerActivity, profile

    from kubernetes_tpu_torch.scheduler import Scheduler

    cell, build, _recheck = CELLS[phase]
    warm_up(phase)
    nodes, bound, pending = build()
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
    trace = os.path.join(out_dir, f"{cell}_cycle_trace.json")
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
    emit({"phase": "profile", "cell": cell,
          "cycle": 1, "scheduled": r.scheduled, "rounds": r.rounds,
          "host_syncs": r.host_syncs,
          "wall_s_profiled": wall, "solve_s": r.solve_s,
          "device_events": len(dev_events),
          "device_busy_s": busy_us / 1e6,
          "device_busy_share": busy_us / 1e6 / wall,
          "top_device_ops": [{"name": k, "count": c, "device_ms": us / 1e3}
                             for k, (c, us) in top]})
    if not dev_events:
        fail("profile: the trace holds no device events")


def phase_parity() -> None:
    """One reduced cycle of each cell on CUDA (kernels) and on CPU tensors
    (plain versions): placements and rounds must be identical."""
    from kubernetes_tpu_torch.scheduler import Scheduler

    for cell, build, _recheck in CELLS.values():
        out = {}
        for dev in ("cuda", "cpu"):
            nodes, bound, pending = build(n_nodes=1000, n_bound=200,
                                          n_pending=2048, seed=11)
            r = drive(Scheduler(device=dev), nodes, bound, pending,
                      max_cycles=1)
            out[dev] = r[0]
        a, b = out["cuda"], out["cpu"]
        if a.assignments != b.assignments or a.rounds != b.rounds:
            diff = sum(1 for k in a.assignments
                       if b.assignments.get(k) != a.assignments[k])
            fail(f"parity {cell}: CUDA and CPU placements differ ({diff} "
                 f"pods, rounds {a.rounds} vs {b.rounds})")
        emit({"phase": "parity", "cell": cell, "nodes": 1000,
              "pending": 2048, "scheduled": a.scheduled, "rounds": a.rounds,
              "identical": True})


# ---------------------------------------------------------------------------
# phase 7: preemption, nominated pods and the explain report
# ---------------------------------------------------------------------------

PREEMPTOR_PRIORITY = 1000


class FakeClock:
    """The scheduler's clock, advanced by hand between cycles."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def preempt_cell(n_nodes=5000, per_node=4, n_ordinary=4064, n_preemptors=32,
                 n_poachers=64, seed=7):
    """Cell ``preempt-5k-burst``: scheduler_perf's PreemptionBasic (a full
    cluster of low-priority pods takes a burst of high-priority pods) on
    the smoke cell's nodes, plus a PodDisruptionBudget and ordinary
    traffic that competes with the nominated preemptors. Each node holds
    ``per_node`` bound pods of priority 0, 900m / 4 Gi (bound pod k on
    node k // per_node); every 10th is labelled ``app=guarded`` and one
    PDB with disruptionsAllowed 0 covers them. Wave 1: ``n_ordinary``
    pods of priority 0, 100m / 500 Mi with the smoke cell's preferred
    zone and toleration mix (they fit in the 400m each node has left) and
    ``n_preemptors`` of priority 1000, 3000m / 500 Mi with the same zone
    preference (they fit nowhere until three victims leave a node).
    Wave 2: ``n_poachers`` of priority 0, 2000m / 500 Mi, which fit only
    on the nodes preemption freed. Returns
    (nodes, bound, wave1, poachers, pdb)."""
    import random

    from kubernetes_tpu_torch.api.types import Toleration
    from kubernetes_tpu_torch.testing import (
        make_pdb,
        make_pod,
        node_affinity_preferred,
        req,
    )

    rng = random.Random(seed)
    nodes, _bound, _pending = smoke_cell(n_nodes=n_nodes, n_bound=0,
                                         n_pending=0)
    bound = [make_pod(f"bound-{k}", cpu_milli=900, memory=4 * 2**30,
                      node_name=f"node-{k // per_node}",
                      labels={"app": "guarded" if k % 10 == 0 else "filler"})
             for k in range(n_nodes * per_node)]
    tol = (Toleration(key=SOFT_TAINT, operator="Exists",
                      effect="PreferNoSchedule"),)

    def prefer():
        return node_affinity_preferred(
            (50, [req(ZONE, "In", f"zone-{rng.randrange(10)}")]))

    wave1 = [make_pod(f"pod-{i}", cpu_milli=100, memory=500 * 2**20,
                      affinity=prefer(), tolerations=tol if i % 2 else ())
             for i in range(n_ordinary)]
    wave1 += [make_pod(f"preemptor-{i}", cpu_milli=3000, memory=500 * 2**20,
                       affinity=prefer(), priority=PREEMPTOR_PRIORITY)
              for i in range(n_preemptors)]
    poachers = [make_pod(f"poacher-{i}", cpu_milli=2000, memory=500 * 2**20)
                for i in range(n_poachers)]
    return nodes, bound, wave1, poachers, make_pdb("guarded",
                                                   {"app": "guarded"})


def run_preempt_cell(cell, device="cuda", max_cycles=8):
    """Drive the cell through ``Scheduler(device=...)`` on a fake clock:
    wave 1, then (inside the preemptors' 1 s backoff) wave 2, then the
    poachers leave (a cancelled job) and the clock jumps past every
    backoff before each later cycle, until every preemptor is bound. The
    host's real clock would not do: one preemption pass takes seconds, so
    the backoff would run out inside cycle 1. Returns (results, wall
    seconds per cycle, peak bytes per cycle, events per cycle)."""
    import torch

    from kubernetes_tpu_torch.scheduler import Scheduler

    nodes, bound, wave1, poachers, pdb = cell
    on_card = torch.device(device).type == "cuda"
    clock = FakeClock()
    events = []
    sched = Scheduler(device=device, clock=clock, pdb_lister=lambda: [pdb],
                      event_sink=lambda r, p, m: events.append((r, p, m)))
    for nd in nodes:
        sched.on_node_add(nd)
    for p in bound + wave1:
        sched.on_pod_add(p)
    results, walls, peaks, by_cycle = [], [], [], []

    def cycle():
        del events[:]
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = sched.schedule_cycle()
        if on_card:
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated())
        walls.append(time.perf_counter() - t0)
        results.append(r)
        by_cycle.append(list(events))

    cycle()
    clock.t += 0.5
    for p in poachers:
        sched.on_pod_add(p)
    cycle()
    for p in poachers:
        sched.on_pod_delete(p)
    preemptors = {p.key() for p in wave1 if p.priority == PREEMPTOR_PRIORITY}
    bound_keys = set()
    while len(results) < max_cycles:
        for r in results:
            bound_keys.update(r.assignments)
        if preemptors <= bound_keys:
            break
        clock.t += 11.0  # past the longest backoff (10 s)
        cycle()
    return results, walls, peaks, by_cycle


def recheck_preempt(cell, results, events_by_cycle) -> dict:
    """Host re-check of the preempt cell, independent of the port. Returns
    the counts it checked."""
    nodes, bound, wave1, poachers, _pdb = cell
    by_key = {p.key(): p for p in bound + wave1 + poachers}
    assignments = {}
    for r in results:
        assignments.update(r.assignments)
    missing = [p.key() for p in wave1 if p.key() not in assignments]
    if missing:
        fail(f"preempt: {len(missing)} wave-1 pods never bound, e.g. "
             f"{missing[:3]}")
    poacher_keys = {p.key() for p in poachers}
    if poacher_keys & set(assignments):
        fail("preempt: a poacher was bound onto capacity promised to a "
             "nominated preemptor")
    # the pass-A cycle: every poacher held off, its explain row showing
    # the nominated (freed) nodes feasible and Insufficient cpu elsewhere
    nominated = set(results[0].nominations.values())
    r2 = results[1]
    if r2.attempted != len(poachers) or r2.scheduled:
        fail(f"preempt: pass-A cycle attempted {r2.attempted}, scheduled "
             f"{r2.scheduled}")
    for key in poacher_keys:
        pe = r2.explain.pods.get(key)
        if pe is None or pe.feasible_nodes != len(nominated):
            fail(f"preempt: poacher {key} explain row "
                 f"{pe and pe.to_json()} (want {len(nominated)} feasible)")
        want = f"{len(nodes) - len(nominated)} Insufficient cpu"
        if want not in r2.fit_errors.get(key, ""):
            fail(f"preempt: poacher {key} FitError "
                 f"{r2.fit_errors.get(key)!r} lacks {want!r}")
    # victims: lower priority than their preemptor, on the node it was
    # nominated to in the same cycle
    victims = []
    for r, events in zip(results, events_by_cycle):
        for reason, v, msg in events:
            if reason != "Preempted":
                continue
            pre = by_key[msg[len("by "):]]
            if v.priority >= pre.priority:
                fail(f"preempt: victim {v.key()} priority {v.priority} >= "
                     f"{pre.key()}'s")
            if v.node_name != r.nominations.get(pre.key()):
                fail(f"preempt: victim {v.key()} on {v.node_name}, "
                     f"preemptor nominated to {r.nominations.get(pre.key())}")
            if v.labels.get("app") == "guarded":
                fail(f"preempt: guarded pod {v.key()} was evicted")
            victims.append(v.key())
    if sum(r.preempted for r in results) != len(victims):
        fail("preempt: Preempted events and CycleResult.preempted disagree")
    if len(set(victims)) != len(victims):
        fail("preempt: a victim was evicted twice")
    gone = set(victims)
    recheck_capacity(nodes, [p for p in bound if p.key() not in gone],
                     assignments, by_key)
    for r in results:
        if r.solver_tier != "batch" or r.solver_fallbacks:
            fail(f"preempt: a cycle solved on tier {r.solver_tier!r} after "
                 f"{r.solver_fallbacks} fallbacks")
    return {"victims": len(victims), "nominated_nodes_cycle1":
            len(nominated), "preemptors_bound":
            sum(1 for p in wave1 if p.priority == PREEMPTOR_PRIORITY)}


def phase_preempt() -> dict:
    """Drives cell ``preempt-5k-burst`` at full width through
    ``Scheduler(device="cuda")`` (after the same sequence on a 100-node
    cell, off the clock) and fails unless every host re-check passes and
    the fused pair kernel launched. Returns the kernel launches of the
    full-width run and its cycle count."""
    import torch

    from kubernetes_tpu_torch import kernels

    run_preempt_cell(preempt_cell(n_nodes=100, n_ordinary=80, seed=1))
    cell = preempt_cell()
    kernels.reset_launches()
    results, walls, peaks, events = run_preempt_cell(cell)
    launches = dict(kernels.LAUNCHES)
    shapes = launch_shapes()
    checked = recheck_preempt(cell, results, events)
    if launches["fused_pair_normalize"] <= 0:
        fail("preempt: the fused-pair kernel was never launched")
    emit({"phase": "preempt", "cell": "preempt-5k-burst",
          "nodes": len(cell[0]), "bound": len(cell[1]),
          "wave1": len(cell[2]), "poachers": len(cell[3]),
          "cycles": len(results),
          "attempted": [r.attempted for r in results],
          "scheduled": [r.scheduled for r in results],
          "preempted": [r.preempted for r in results],
          "nominations": [len(r.nominations) for r in results],
          "wall_s": walls,
          "preempt_s": [r.preempt_s for r in results],
          "explain_s": [r.explain_s for r in results],
          "rounds": [r.rounds for r in results],
          "host_syncs": [r.host_syncs for r in results],
          "preempt_rows_bytes": [r.preempt_rows_bytes for r in results],
          "peak_mem_gib": [b / 2**30 for b in peaks],
          "snapshot_mode": [r.snapshot_mode for r in results],
          "top_reasons": [r.explain.top_reasons() if r.explain else None
                          for r in results],
          "launches": launches, "recheck": checked})
    torch.cuda.empty_cache()
    return {"launches": launches, "cycles": len(results), "shapes": shapes}


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def _kernel_name(mangled: str) -> str:
    """The kernel's identifier inside a mangled name, with its template
    argument (``v_kernel<1>`` for ``...8v_kernelILb1E...``)."""
    import re

    for m in re.finditer(r"(?=(\d+)([A-Za-z_]\w*))", mangled):
        size = int(m.group(1))
        ident = m.group(2)[:size]
        if len(ident) == size and ident.endswith("kernel"):
            t = re.match(r"ILb(\d)E", m.group(2)[size:])
            return ident + (f"<{t.group(1)}>" if t else "")
    return mangled


def ptxas_summary(reports: dict) -> dict:
    """Registers, static shared memory and spills of each kernel function,
    from the ``-Xptxas=-v`` report of each library built in this run (the
    staged pair kernel's dynamic shared memory, 9 bytes an element of its
    row, is set at launch)."""
    import re

    out = {}
    for lib, text in reports.items():
        got = None
        for ln in text.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?(\w+)", ln)
            if m:
                got = out.setdefault(f"{lib}:{_kernel_name(m.group(1))}", {})
                continue
            if got is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m:
                got["spill_stores"] = int(m.group(1))
                got["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                got["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", ln)
                got["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


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
                    help="also profile the first cycle of the smoke and the "
                         "topology cell, traces into DIR")
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
              "ptxas": ptxas_summary(reports)})

    rows: dict = {}
    if "kernels" in phases:
        check_kernels(rows)
        emit({"phase": "kernels", "ok": True})

    paths = {}
    if "smoke" in phases:
        paths["smoke"] = phase_cell("smoke")
    if "plan" in phases:
        paths["plan"] = phase_plan()
    if "topology" in phases:
        paths["topology"] = phase_cell("topology")
    if "parity" in phases:
        phase_parity()
    if "preempt" in phases:
        paths["preempt"] = phase_preempt()
    if args.profile:
        for phase in CELLS:
            profile_cycle(args.profile, phase)
    if "kernels" in phases:
        time_main_shapes(rows, paths)
    out = []
    for name, meta in KERNELS.items():
        r = dict(name=name, **meta)
        r.update(rows.get(name, {}))
        by_path = {p: got["launches"][name] for p, got in paths.items()}
        r["launches"] = sum(by_path.values())
        r["launches_by_path"] = by_path
        r["launches_per_cycle"] = {p: got["launches"][name] / got["cycles"]
                                   for p, got in paths.items()}
        if name == "fused_pair_normalize":
            r["launches_wide"] = sum(
                got["launches"]["fused_pair_normalize_wide"]
                for got in paths.values())
        # every kernel serves at least one main path: once all of them
        # ran, a kernel that none of them launched is a failure
        if set(MAIN_PATHS) <= set(paths) and r["launches"] <= 0:
            fail(f"kernel {name} was never launched on the main paths")
        out.append(r)
    emit({"kernels": out})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
