"""Chip smoke test for the PyTorch/CUDA port (``kubernetes_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``kubernetes_tpu_torch/csrc`` (one
``nvcc`` per source, in parallel), then runs eighteen phases and exits
non-zero if any fails:

1. environment: card name and power limit, torch/CUDA versions, build time,
   each kernel function's registers, shared memory and spills (ptxas);
2. every kernel against its plain PyTorch version on the card, at the main
   path's padded shape (8192 x 8192) and a ragged one (5000 x 3000); the
   fused pair also on the widest staged row (1024 x 12288), a row past the
   staged limit (256 x 16384) and the smallest bucket (64 x 8), each on
   the path its route names; u and v in both rules (the fixed-iteration
   Pallas rule and the tolerance loop's jnp rule); the v pass also at
   1000 x 3001, and twice to the same bits. Times at 8192 x 8192 (the pair's wide path beside its
   staged one) and, once the main paths ran, the pair and the v pass held
   again and timed at the shapes those paths launched;
3. the main path at full width, cell ``smoke-5k-prefaffinity``: 5000
   nodes, 1000 bound pods, 10,000 pending pods with preferred zone
   affinity and a PreferNoSchedule taint on every 10th node, through
   ``Scheduler(device="cuda")`` until the queue drains (its 8192-pod
   cycle pipelines in 2 chunks at the defaults, the 1808-pod one does
   not);
4. the kernel-route policy (``KTPU_PALLAS``, the reference's
   ``use_pallas`` variable), cell ``smoke-5k-prefaffinity`` at full width
   in two fresh schedulers, the variable unset (the deployment default)
   and ``"1"``: both launch the pair and place alike, and each arm's
   cycle seconds are printed. The plain route is refused on the card:
   under ``"0"`` a scheduler on the card, a solve and a plan on its
   tensors, and unset ``fused_score=False`` and ``pallas=False``, each
   raise ``PlainRouteRefused`` and launch none of the six hand-kernel
   entries. Unset is decided per process, so CPU tensors beside the card
   take the card's route: the tied-preferences workload (which the
   auto-router plans) places on them as on the card, and the seeded
   zero-capacity plan agrees on both. Every other phase runs the
   deployment default;
5. the plan path: ``Scheduler(solver="sinkhorn")`` on the same cluster
   with 4096 pending pods (one Sinkhorn stats sample a cycle, riding the
   solve's readback, on the flight record and in
   ``scheduler_sinkhorn_iterations``), the same path reduced (500 nodes,
   1024 pods) on the card and on CPU tensors with equal placements and
   stats (the residual within atol 1e-5 / rtol 1e-4), then the
   tied-preferences workload through the default auto-router;
6. the topology path at full width, cell ``topo-5k-mixed``: the same
   cluster with 10,000 pending pods mixing preferred zones, hostname pod
   anti-affinity, zone pod affinity, and hard and soft topology spread,
   checked by a host re-check of every constraint;
7. one reduced cycle of each cell (1000 nodes x 2048 pods), and a reduced
   run of the sparse cell (1000 nodes, C = 64, a 512-pod burst, then 8
   micro-batches), on CUDA and on CPU tensors (the plain versions) must
   place identically, with the same solve scopes;
8. the failure path at full width, cell ``preempt-5k-burst``: 5000 full
   nodes (20,000 bound low-priority pods, some under a PDB) take 4064
   ordinary pods and 32 high-priority preemptors, then 64 poachers that
   only the freed nodes could hold, on a hand-advanced clock: preemption,
   nominated pods (pass A) and the explain report, checked by a host
   re-check of every victim, nomination, poacher and node;
9. the sparsity-first routes at full width, cell ``sparse-5k-churn``: the
   smoke cell's 5000 nodes and 1000 bound pods through
   ``Scheduler(incremental=IncrementalConfig(enabled=True, primary=True,
   candidate_bucket=256))``, once with ``solver="batch"`` and once with
   ``solver="sinkhorn"`` and warm potentials: a cold burst of 4096 pods
   (partitioned: 8 blocks of 256 columns), then 48 steady cycles of 8
   deletes and 16-128 new pods (restricted to 256 candidate columns), a
   node added mid-run (partitioned again) and a last cycle whose misfit
   pod sends the cycle to the dense ladder; checked by the exact scope
   sequence, the capacity re-check, the misfit's FitError and the
   incremental metric families (a count per cycle by scope, the reuse
   gauge, the warm state's drops);
10. the pipelined cycle executor at full width, cell ``pipeline-5k-30k``
   (the reference bench's headline: 5000 nodes, 1000 bound, 30,000
   pending smoke pods in batches of 8192, each cycle in 2 chunks of at
   most 4096), at depth 2 and at depth 1: every chunk's dispatch runs
   under ``torch.cuda.set_sync_debug_mode("error")`` (at depth 2 the
   whole cycle does, the observability facade at its defaults), each
   cycle's host syncs are bounded by its chunks, explain readbacks and
   router decisions, and the spans' host seconds (pack, dispatch,
   readback, bind), rounds and pods/s are printed; at depth 2 every cycle
   leaves one flight record whose spans are its trace's and whose
   readback bytes are the bytes ``ops/sync.to_host`` moved, with no
   retrace or graph capture after the first cycle; the depth-2 run again
   with the facade, the journeys and the perf and memory ledgers and the
   incident recorder off must place and sync alike, and once more on
   (on, off, on: every run's cycle seconds printed, the facade's host
   cost); then one profiled pipelined
   cycle (the device's idle share) and a reduced run (500 nodes, 3000
   pods, chunks of 512) whose depth-2, depth-3 and CPU placements must
   agree. The device round loop (``csrc/graph_loop.cu``) is then held
   against its plain version, the Python loop, on the first chunk's
   inputs;
11. the configured scheduler: every arm's configuration is a JSON
   v1alpha1 ``KubeSchedulerConfiguration`` written to a temporary
   directory, loaded with ``cli.load_config_file`` and built with
   ``Scheduler.from_config``. Arm A, cell ``pipeline-5k-30k`` with
   ``solver: batch`` and ``solver: sinkhorn`` and ``warmup`` on: the
   scheduler warms with the first 64 pending pods after the node sync
   (as ``cli.run``'s gate does); no cycle may capture a round-loop graph
   after warmup, every pod binds on the configured tier, placements equal
   a hand-built ``Scheduler``. Arm B, the ladder (5000 nodes, 1024
   pending): each raising and poisoning fault kind at ``solve:batch``
   gives the retry then ``batch-cpu`` with the fault-free placements; the
   breaker opens, sheds and half-opens on a hand-advanced clock; a blown
   ``cycleDeadline`` skips to ``greedy``; a ``KernelError`` reaches the
   caller. Arm C, ``solver: exact`` (500 nodes, 512 pending): equal to
   ``native.exact_assign`` recomputed on the recorded host matrices and
   to the same cycle on CPU tensors; a topology batch routes to
   ``batch``. Arm D (5000 nodes): 256 pods through an extender this
   script serves on 127.0.0.1, then ``percentageOfNodesToScore: 50``:
   every bound node passed the extender's filter and lies in its cycle's
   ``NodeTree.take(k)`` subset;
12. the serve loop, cell ``serve-5k-churn``: the smoke cluster (5000
   nodes, 1000 bound pods) under create/delete churn in 10 Hz bursts at
   500 ops/s (``scripts/bench_churn.py``'s default), pods of the smoke
   cell's shape. Arm A runs ``cli.run`` with the ServingRuntime (window
   max 20 ms, warmup from bucket 8) behind an elector on an in-memory
   lock for 30 s: every created pod binds exactly once, no graph is
   captured after warmup, every flush is bucket-fill or max-wait, one
   mid-run cycle runs clean under ``torch.cuda.set_sync_debug_mode(
   "error")`` and one is profiled; a ``soak.SoakEngine`` attached for the
   arm runs the churn as a traffic phase between clean phases, and its
   leak sentinels' growth verdict must find no leak; every bound pod
   closes its journey (create-to-bind p50 / p99 printed beside the
   cycle results'), and ``/debug/flightrecorder``, ``/debug/journeys``
   (``?pod=`` one bound pod's timeline), ``/debug/soak`` and the
   unschedulable families on ``/metrics`` answer; arm C floods creates for 10 s through
   the runtime's mutating APF flow (sheds, every admitted pod bound);
   arm B is the legacy fixed-interval loop (``--cycle-interval 0.25``)
   for 20 s; arm D fails over between two ServingRuntimes on one lock and
   one CAS binder (``solver: sinkhorn``, lease cut to 2 s / 1.5 s /
   0.5 s), the leader killed at 8 s by ``chaos.KillingBinder`` just
   after a bind's CAS committed (no release, the torn cycle's binds
   never relayed to the standby): zero double binds, the standby's
   reconcile adopts every torn bind, and it binds the rest, both
   replicas observe the Sinkhorn families and a standby record carries
   the takeover; arm E runs ``python -m
   kubernetes_tpu_torch`` as a process (``/healthz``, ``/metrics``, the
   lock file, rc 0 on SIGTERM) and 128 extender POSTs whose answers
   equal the same scheduler's on CPU tensors;
13. the hollow cluster, cell ``hollow-5k-controllers``: arm A builds
   ``sim.HollowCluster`` (admission, one tick of watch delay, a competing
   writer, flaky binds) with its scheduler on the card at its defaults,
   5000 smoke-cell nodes, a DaemonSet (a pod per node), 2500 pods of
   Deployments and zone-preferring bare pods, a Job of 500 and a
   StatefulSet of 1 (the pod count cut, ``HOLLOW_FULL``); it steps until
   every pod is bound, then 3 churn steps of 320 s (pods killed, nodes
   removed, 50 kubelets killed, their pods evicted; healed after the
   last, their nodes restored in arm B's first step),
   ``check_consistency`` after every step, one step profiled; the same
   traffic at 500 nodes and 3000 pods
   must give the same truth step by step on the card and on CPU tensors;
   arm B serves the hub over ``restapi.RestServer`` on 127.0.0.1 and
   feeds a second scheduler (``Scheduler.from_config``, ``solver:
   sinkhorn``, ``watchProgressDeadline: 5s``) only through a
   ``sim.Reflector``: 2000 pods created over REST, an NDJSON watch that
   must see every binding once, a compaction (410 and relists), a stalled
   watch relisting past the deadline, the whole node and pod lists in
   protobuf decoding to the JSON lists' objects;
14. the recovery paths: arm A, cell ``netchaos-5k``, ``chaos.NetChaos``
   at the reference's default fault rates (ambiguous bind timeouts, bind
   errors, verification GET timeouts, a dropping, duplicating and
   reordering watch, a relist storm) on a ``sim.HollowCluster`` of the
   smoke cell's 5000 nodes and 2000 pending pods, once with the default
   solver and once with ``solver: sinkhorn``: every pod bound, no
   double-bind attempt, no auditor violation, nothing leaked or parked,
   the flight records' ambiguous binds and violations the harness's
   counts; the same at 500 nodes x 1000 pods on the card and on CPU
   tensors must
   give equal reports. Arm B, cell ``devloss-5k``: six cycles of 1024 pods
   on the smoke cluster through ``Scheduler.from_config`` (recovery
   {deviceResetLimit: 2, deviceCooloff: 30s}, warmup) while the
   ``snapshot:device`` seam fails (one ``device_lost``, then three: host
   mode through the cooloff, resident again after it; the same with
   ``device_oom``), with ``deviceResidentSnapshot: false``, and after a
   warmup that lost the device: every cycle places as a fault-free
   twin's, resets equal the faults injected (and the flight records'
   device resets with their forensic flags, the aborted warmup's flag
   parked for the next record), no graph is captured after
   warmup and every cycle runs under sync-debug ``error``; the
   allocator's bytes around each drop of the resident table; every reset
   leaves the memory ledger's forensic flag (``oom@snapshot:device
   top=cache.node_table:...``), one ``oom`` incident bundle and the
   ranked record on ``/debug/memory``. Arm C, cell ``ha-5k``: two
   ``chaos.HAReplica`` on one hub of 5000 nodes, 2000 pods created while
   the leader is killed: the standby takes over and binds every pod
   exactly once. No other phase may reset the device or run a host-mode
   cycle;
15. the device backends of observability, cell ``ledger-5k``: the smoke
   cell's cluster, every scheduler from a JSON v1alpha1 file through
   ``Scheduler.from_config``, monolithic cycles, warmup at pod buckets
   1024-8192 (N = 8192). Arm A: the backends at their defaults against a
   twin with all three off over 4 cycles of 8192 pods and one at each
   smaller bucket: equal placements and host syncs, 0 graph captures
   after warmup, the cost model's efficiency in (0, 8] with a basis from
   the second cycle, one memory-ledger entry a cycle from the allocator
   with preflight ``ok``, each bucket's captured bytes at least 90% of a
   live cycle's peak at that bucket, the backends' host seconds. Arm B:
   ``memoryLedger.limitBytes`` from A's table so an 8192 batch splits to
   4096 and places as a twin capped at 4096, every pod binds, then a
   limit under the smallest bucket sheds every cycle with every pod kept
   queued, the preflight counter equal to the verdicts, no out-of-memory
   record. Arm C: ``costDriftRatio: 2.0`` over 2 s / 4 s windows; bursts
   of 8192 pods after 64-pod cycles burn it (``slo``, the event, the
   scheduler degraded at 4x pressure, one ``slo-burn`` bundle and its
   ``torch.profiler`` trace naming the fused pair's kernel, no profiler
   error), 64-pod cycles recover it, and ``/debug/ledger``,
   ``/debug/memory``, ``/debug/incidents`` and ``/debug/profile`` answer
   over HTTP with the reference's keys;
16. the scenario packs, every scheduler from a JSON v1alpha1 file with a
   ``scenario:`` block through ``Scheduler.from_config``. Arm A, cell
   ``scenario-5k-consolidation``: the smoke cell through ``pack:
   consolidation`` under ``solver: batch`` and ``solver: sinkhorn``,
   each beside a stock twin: equal pods placed, the device's
   ``nodes_used`` strictly below the twin's and equal to the host's
   count (headroom, fragmentation and priority headroom re-counted on
   the host), the capacity re-check. Arm B, cell ``scenario-5k-gang``:
   the reference bench's BASELINE config 4 (5000 nodes over 10 zones,
   1000 gangs of 32) through ``pack: gang-topology`` beside a stock
   twin: every gang whole (success 1.0, 0 partial binds), the locality
   the host counts, at or above the twin's. Arm C: the preempt cell's
   wave 1 under ``pack: consolidation, preemptInBatch: true``: every
   preemptor binds in the cycle that preempted for it, every displaced
   pod re-places or requeues, no guarded pod evicted, capacity clean,
   ``scheduler_scenario_cascade_victims_total`` the victims evicted.
   Arm D: ``sparse-5k-churn``'s traffic with small gangs through the
   restricted route under ``pack: gang-topology, quality: false`` (a
   restricted cycle with a hint, every gang on its home slice), and the
   re-pack on a hand-advanced clock (no drain between intervals, at most
   ``repackMaxPods`` a sweep, ``nodes_used`` falling). Then each pack
   warmed (0 captures and retraces over three cycles), both packs at 500
   nodes x 1024 pods equal on the card and on CPU tensors, and one
   quality-on cycle of each under sync-debug ``error`` making one sync
   more than its quality-off twin;
17. the protobuf codec and the gRPC seam, cell ``grpc-5k-deltas``, over
   ``grpc_shim.serve_grpc`` on 127.0.0.1 where ``grpcio`` imports, else
   over an in-process loopback that serializes every message each way
   with the port's codec (the line names the transport; both are token
   gated and a forged token must be refused). Arm A: the smoke cell's
   cluster (5000 nodes, 1000 bound) listed from a ``sim.HollowCluster``
   by ``SnapshotDeltaBridge`` as typed deltas, 4096 pending pods
   arriving as PodDelta ADDs, a service-side ``Scheduler(device=
   "cuda")`` scheduling until its queue is empty and binding through the
   hub's CAS binder, then 64 pods through Filter and Prioritize (node
   names only, each answer equal to the ``ExtenderServer`` JSON verbs')
   and Bind; every streamed payload decodes as its JSON does, every ack
   is its delta's revision and the hub's, every pod binds exactly once;
   one GetState rendered by kubectl's ``get``, ``top`` and
   ``describe``; the REST node and pod lists in protobuf, whole and
   paged, equal to the JSON lists; the 5000-node list's bytes and host
   encode / decode seconds against JSON. Arm B: the reference
   integration test's convergence under ``solver="sinkhorn"`` on 1000 of
   the smoke nodes and 500 of its pods, then a ReplicaSet, a churn step
   and the controller's refeed. Arm C: arm A's stream at 500 nodes x
   1024 pods places equally on the card and on CPU tensors;
18. the node-axis mesh (``parallel.mesh``), every scheduler a
   JSON v1alpha1 file through ``Scheduler.from_config``; every mesh of
   d > 1 runs the partitioned solve (one program per shard, the
   cross-shard reductions of ``parallel/collectives.py``, the split pair
   and u kernels). Arm A: the smoke
   cell at full width under ``parallel: {mesh: auto}`` (a mesh of 1 on
   one card) beside a mesh-off twin: equal placements, rounds and host
   syncs, the pair launched as often, ``+mesh1`` in every batch shape,
   the gauge and each flight record's mesh at 1, one cycle under
   sync-debug ``error``. Arm B: a logical 8-shard mesh (8 copies of the
   card) over ``sparse-5k-churn``'s cluster, a 1024 burst and 8 steady
   cycles under ``batch`` and ``sinkhorn``, beside an unsharded twin: the
   same scopes and placements, every pod bound once, u and v launched;
   at 500 nodes the same on the card and on CPU tensors. Arm C: a lost
   device at ``solve:batch`` answered by the ``batch-single`` rung
   (every pod bound, as the fault-free twin), and a ``KernelError`` on
   the rung reaching the caller. Arm D: ``chaos.MeshChaos`` loses a
   shard mid-run (host mode through a 5 s cooloff on a hand-advanced
   clock, the flight records' mesh 0 then 8, resets equal to the shots,
   the healed table back on the mesh), then a composed
   ``ServingRuntime`` on a 2-shard mesh loses one mid-churn: every pod
   bound exactly once, no graph captured after warmup. Arm E: the smoke
   cell at full width over 2 and 4 copies of the card, monolithic and
   pipelined, each beside a mesh-off twin: equal placements and rounds,
   one cycle under sync-debug ``error``, the split pair launched, the
   collectives of a round body beside the cost model's payloads; then
   ``solver: sinkhorn`` with 4096 pods on 4 shards: equal placements, u
   (split) and v launched. Arm E2 runs ``mesh: auto`` over every card
   where there are two or more, and otherwise prints that it did not.
   Phase 2 also holds the split kernels (``fused_pair_max``,
   ``fused_pair_scale``, ``sinkhorn_u_partial``) and the whole v pass a
   shard runs against their plain versions at (8192, 8192 / d) for d in
   2, 4, 8, the u pass in both rules, to the same bits over two launches
   and on edge inputs, each timed warm and with the L2 cold; once the
   mesh phase ran, the u and v passes again at every shape it launched.

Lines of JSON report each phase, then the whole run's seconds and each
phase's (``"phase": "total"``); the line before the last lists every
kernel with its launches on the main paths (the smoke cell, the
kernel-route arms, the plan path, the topology path, the preempt cell,
the sparse cell, the pipeline cell, the configured scheduler's arm A,
the serve loop's arms A-D, the hollow cluster's arms A and B, the
recovery phase's arms A-C, the ledger phase's arms A-C, the scenario
phase's arms and
the grpc phase's arms A-C and the mesh phase's arms A-E2,
each counted from 0 just before it runs: ``launches`` is
their sum, ``launches_by_path`` and ``launches_per_cycle`` split it; the
sparse cell's frame shapes are held and timed again under
``sparse_shapes``, the serve loop's micro-batch shapes of every kernel
under ``serve_shapes``, the hollow cluster's under ``hollow_shapes``,
the recovery cells' under ``recovery_shapes``, the ledger cell's
under ``ledger_shapes`` and the scenario arms' under
``scenario_shapes``), error against the plain
version, times and bound (``ms``, ``plain_ms`` and ``library_ms`` are single-call
CUDA-event medians; ``ms_batched`` times back-to-back calls,
``device_ms`` is the trace's device time and ``device_ms_cold`` the
kernel's own trace time with the L2 flushed before each launch); the
last line is the one-line
contract
``{"ok": true, "device": {...}}``. Without a CUDA card it exits non-zero
and prints no result. ``--phases`` runs a subset (comma-separated names:
env, kernels, smoke, route, plan, topology, parity, preempt, sparse,
pipeline, config, serve, hollow, recovery, ledger, scenario, grpc, mesh);
``--profile DIR``
adds one profiled first cycle of the smoke cell and of the topology cell
(device time by kernel, traces written to DIR).
"""

from __future__ import annotations

import argparse
import contextlib
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

ALL_PHASES = ("env", "kernels", "smoke", "route", "plan", "topology",
              "parity",
              "preempt", "sparse", "pipeline", "config", "serve", "hollow",
              "recovery", "ledger", "scenario", "grpc", "mesh")
#: the phases that drive a main path and count its kernel launches
MAIN_PATHS = ("smoke", "route", "plan", "topology", "preempt", "sparse",
              "pipeline", "config", "serve", "hollow", "recovery", "ledger",
              "scenario", "grpc", "mesh")
#: the phases that inject device faults (any other phase fails on a
#: device reset or a host-mode cycle)
FAULT_PHASES = ("recovery", "mesh")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    # every thread the script starts is a daemon: a failure ends the
    # process even while a serve loop is still running
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
    got: dict = {}
    # a trace can come back without device events (seen on the first
    # profile taken after another profile in the process): one retry
    for _attempt in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            name = re.sub(r"\(anonymous namespace\)::|^void ", "", e.name)
            name = name.split("(")[0].strip()[:60]
            t, c = got.get(name, (0.0, 0))
            got[name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
        if got:
            break
    return {"per_call": (sum(t / c * max(1, round(c / reps))
                             for t, c in got.values()) if got else None),
            "by_kernel": {k: {"ms": t / c, "count": c}
                          for k, (t, c) in got.items()}}


#: the L2-cold timing's flush (H100: a 50 MB L2): a scratch buffer
#: overwritten between launches, then a second one read, so the L2 holds
#: none of the kernel's inputs and no dirty lines whose write-back the
#: kernel's misses would pay for
FLUSH_WRITE_BYTES = 64 << 20
FLUSH_READ_BYTES = 96 << 20
_FLUSH: dict = {}


def l2_flush() -> None:
    """Evict the card's L2 (outside any timed span): overwrite a 64 MB
    scratch buffer, then read a 96 MB one."""
    import torch

    if not _FLUSH:
        _FLUSH["w"] = torch.empty(FLUSH_WRITE_BYTES // 4, device="cuda")
        _FLUSH["r"] = torch.ones(FLUSH_READ_BYTES // 4, device="cuda")
    _FLUSH["w"].fill_(1.0)
    _FLUSH["r"].amax()


def cold_ms(fn, kernel: str, reps: int = 10) -> dict:
    """Device milliseconds of the kernel named ``kernel`` (a prefix of its
    trace name) in ``fn()``, each call after :func:`l2_flush`: the mean
    of the kernel's own trace entries (the flush's kernels are not in
    it), with their count; ``ms`` None when the trace holds none."""
    def call():
        l2_flush()
        fn()

    got = device_ms(call, reps)["by_kernel"]
    hits = [v for k, v in got.items() if k.startswith(kernel)]
    return {"ms": (sum(h["ms"] * h["count"] for h in hits)
                   / sum(h["count"] for h in hits)) if hits else None,
            "count": sum(h["count"] for h in hits)}


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
    # the pair and the u pass split at their reduction seam: what the
    # partitioned solve (a mesh of d > 1 shards) launches on each shard
    "fused_pair_max": {
        "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/fused_pair.cu",
        "replaces": "kubernetes_tpu/ops/fused_score.py:75 _pair_max_kernel "
                    "(its pallas_call at :123)",
    },
    "fused_pair_scale": {
        "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/fused_pair.cu",
        "replaces": "kubernetes_tpu/ops/fused_score.py:95 "
                    "_pair_scale_kernel (its pallas_call at :141)",
    },
    "sinkhorn_u_partial": {
        "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/sinkhorn.cu",
        "replaces": "kubernetes_tpu/ops/sinkhorn.py:156 _u_kernel (its "
                    "pallas_call at :239), split at its log-sum-exp",
    },
    # not a Pallas kernel: the conditional-node graph and its exit-test
    # kernel that keep the round loop on the card, as the reference's
    # jax.lax.while_loop does
    "round_loop": {
        "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/graph_loop.cu",
        "replaces": "kubernetes_tpu/ops/assign.py:893 jax.lax.while_loop "
                    "(the round loop of _batch_impl; :544 _lean_rounds)",
    },
}

#: the kernels that take (P, N) arrays (timed again at the main shapes)
ARRAY_KERNELS = ("fused_pair_normalize", "sinkhorn_u", "sinkhorn_v")
#: the split kernels of the partitioned solve, one launch per shard
SPLIT_KERNELS = ("fused_pair_max", "fused_pair_scale", "sinkhorn_u_partial")
#: the shard counts the split kernels are held at, on (8192, 8192 / d)
SPLIT_WIDTHS = (2, 4, 8)

#: Sinkhorn passes sum in another order than the plain versions
SINKHORN_ATOL, SINKHORN_RTOL = 1e-5, 1e-4


def sinkhorn_err(got, want):
    """(max |err| over the finite potentials, whether the pass agrees with
    its plain version): within the stated tolerance everywhere, and the
    same entries at or below NEG_INF/2 (the jnp rule keeps a
    zero-capacity column's v near NEG_INF, where one ulp is ~1e23, so
    the error is reported over the other entries)."""
    import torch

    from kubernetes_tpu_torch.ops.sinkhorn import NEG_INF

    live = want > NEG_INF / 2
    ok = (torch.allclose(got, want, atol=SINKHORN_ATOL, rtol=SINKHORN_RTOL)
          and torch.equal(live, got > NEG_INF / 2))
    err = float((got - want).abs()[live].max()) if live.any() else 0.0
    return err, ok


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


def time_sinkhorn_pass(name, P, N, gen, dev) -> dict:
    """A Sinkhorn pass's wrapper held against its plain version in both
    rules at (P, N) (zero-capacity columns in the inputs), then timed in
    the jnp rule (the tolerance loop's, which the sparse path runs) with
    its plain version and library call, and in the Pallas rule."""
    import torch

    from kubernetes_tpu_torch.ops import sinkhorn

    logk, log_r, log_c, u, v = _sinkhorn_inputs(P, N, gen, dev)
    if name == "sinkhorn_u":
        kern, plain, args = sinkhorn.sinkhorn_u, sinkhorn.sinkhorn_u_plain, \
            (logk, v, log_r)

        def lib():
            return torch.logsumexp(logk + v[None, :], 1)
    else:
        kern, plain, args = sinkhorn.sinkhorn_v, sinkhorn.sinkhorn_v_plain, \
            (logk, u, log_c)

        def lib():
            return torch.logsumexp(logk + u[:, None], 0)
    out = {}
    for rule in (False, True):
        got, want = kern(*args, jnp_rule=rule), plain(*args, jnp_rule=rule)
        torch.cuda.synchronize()
        err, ok = sinkhorn_err(got, want)
        tag = "jnp" if rule else "pallas"
        if not ok:
            fail(f"{name} {P}x{N} ({tag} rule): max |err| {err} beyond atol "
                 f"{SINKHORN_ATOL} rtol {SINKHORN_RTOL}")
        out[f"max_abs_err_{tag}"] = err
    out["max_abs_err"] = max(out["max_abs_err_jnp"],
                             out["max_abs_err_pallas"])
    out.update({
        "ms": cuda_time_ms(lambda: kern(*args, jnp_rule=True)),
        "ms_batched": batched_ms(lambda: kern(*args, jnp_rule=True)),
        "device_ms": device_ms(lambda: kern(*args, jnp_rule=True)),
        "ms_pallas_rule": cuda_time_ms(lambda: kern(*args)),
        "plain_ms": cuda_time_ms(lambda: plain(*args, jnp_rule=True)),
        "library_ms": cuda_time_ms(lib)})
    out.update(_sinkhorn_bound(name, P, N))
    return out


def _wide_pair(rf, rr, mask):
    """The pair's wide path launched directly, whatever the row (a timing
    yardstick for the staged path; not a launch of the main path)."""
    import torch

    from kubernetes_tpu_torch.ops import fused_score

    out = torch.empty_like(rf)
    fused_score.launch(rf, rr, mask, out, 1.0, 1.0, staged=False)
    return out


def _split_bound(name, P, n) -> dict:
    """Least time of a split kernel on one (P, n) block: each input read
    once, each output written once."""
    if name == "fused_pair_max":
        return _bound(P * n * (4 + 4 + 1) + 2 * P * 4, P * n * 4)
    if name == "fused_pair_scale":
        return _bound(P * n * (4 + 4 + 4) + 2 * P * 4, P * n * 12)
    return _bound(P * n * 4 + n * 4 + 2 * P * 4, P * n * 5)


#: each kernel's entry in the trace (a prefix of its name there)
TRACE_NAMES = {"fused_pair_normalize": "fused_pair_staged_kernel",
               "sinkhorn_u": "u_kernel",
               "fused_pair_max": "pair_max_kernel",
               "fused_pair_scale": "pair_scale_kernel",
               "sinkhorn_u_partial": "u_partial_kernel",
               "sinkhorn_v": "v_kernel"}
#: row lengths the split u pass is held at on its edge inputs: a block
#: narrower than four columns, not a multiple of four (scalar reads, one
#: or three warp tiles), one tile, one tile and a ragged second, a row
#: four warps share, and one wider than the float4 route takes (scalar
#: reads)
U_EDGE_WIDTHS = (1, 3, 6, 1024, 1028, 3001, 4096, 12288)


def _u_partial_agrees(got, want) -> bool:
    """The split u pass's (shift, sum) against its plain version's within
    the Sinkhorn tolerance."""
    import torch

    return all(torch.allclose(x, y, atol=SINKHORN_ATOL, rtol=SINKHORN_RTOL)
               for x, y in zip(got, want))


def _u_partial_same_bits(logk, v, rule: bool) -> bool:
    """Two launches of the split u pass on the same inputs give the same
    bits (no atomics: the order of every sum is fixed)."""
    import torch

    from kubernetes_tpu_torch.ops import sinkhorn

    one = sinkhorn.sinkhorn_u_partial(logk, v, rule)
    two = sinkhorn.sinkhorn_u_partial(logk, v, rule)
    return all(torch.equal(x, y) for x, y in zip(one, two))


def check_u_partial_edges(logk, v) -> list:
    """The split u pass in both rules against its plain version on edge
    inputs (64 rows): every width of U_EDGE_WIDTHS; at 1024 columns a
    block of all -inf rows, an all-padding block (NEG_INF logk, as a
    shard holding no live node), a live column a row, rows whose max lies
    below NEG_INF (the Pallas rule's clamp), v all NEG_INF, and logk, v
    or both offset by 4 bytes (scalar reads; v staged alike). Returns the
    cases' names."""
    import torch

    from kubernetes_tpu_torch.ops import sinkhorn
    from kubernetes_tpu_torch.ops.sinkhorn import NEG_INF

    rows, n = 64, 1024
    wide = torch.cat([logk[:rows], logk[:rows]], 1)
    wide_v = torch.cat([v, v])
    cases = {f"n{w}": (wide[:, :w].contiguous(), wide_v[:w].contiguous())
             for w in U_EDGE_WIDTHS}
    lk, vb = logk[:rows, :n].contiguous(), v[:n].contiguous()
    one = torch.full_like(lk, float("-inf"))
    at = torch.arange(rows, device=lk.device)
    one[at, (at * 37) % n] = lk[at, (at * 37) % n]
    below = lk.clone()
    below[0] = -2e30
    below[1] = torch.linspace(-3e30, -1.5e30, n, device=lk.device)

    def off4(t):
        buf = torch.empty(t.numel() + 1, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    cases.update({
        "all_-inf_block": (torch.full_like(lk, float("-inf")), vb),
        "all_padding_block": (torch.full_like(lk, NEG_INF),
                              torch.zeros_like(vb)),
        "one_live_column_a_row": (one, vb),
        "max_below_NEG_INF": (below, vb),
        "v_all_NEG_INF": (lk, torch.full_like(vb, NEG_INF)),
        "logk_and_v_off_4_bytes": (off4(lk), off4(vb)),
        "logk_off_4_bytes": (off4(lk), vb),
        "v_off_4_bytes": (lk, off4(vb))})
    for name, (a, b) in cases.items():
        for rule in (False, True):
            got = sinkhorn.sinkhorn_u_partial(a, b, rule)
            want = sinkhorn.sinkhorn_u_partial_plain(a, b, rule)
            if not _u_partial_agrees(got, want):
                fail(f"sinkhorn_u_partial {name} ({'jnp' if rule else 'pallas'}"
                     f" rule): beyond atol {SINKHORN_ATOL} rtol "
                     f"{SINKHORN_RTOL}")
    return sorted(cases)


#: the v pass's edge inputs: row lengths of one column, not a multiple of
#: four (scalar copies), and one past a 128-column strip; row counts of
#: one, one short of a 64-row band, and one past a 4096-row block
V_EDGE_WIDTHS = (1, 3, 6, 130)
V_EDGE_ROWS = (1, 63, 4097)


def _v_same_bits(logk, u, log_c, rule: bool) -> bool:
    """Two launches of the v pass on the same inputs give the same bits
    (no atomics: every merge runs in a fixed order)."""
    import torch

    from kubernetes_tpu_torch.ops import sinkhorn

    return torch.equal(sinkhorn.sinkhorn_v(logk, u, log_c, rule),
                       sinkhorn.sinkhorn_v(logk, u, log_c, rule))


def _v_held(logk, u, log_c, what: str) -> dict:
    """The v pass against its plain version in both rules, and to the same
    bits over two launches; the max error by rule."""
    from kubernetes_tpu_torch.ops import sinkhorn

    errs = {}
    for rule in (False, True):
        got = sinkhorn.sinkhorn_v(logk, u, log_c, rule)
        want = sinkhorn.sinkhorn_v_plain(logk, u, log_c, rule)
        err, ok = sinkhorn_err(got, want)
        tag = "jnp" if rule else "pallas"
        if not ok:
            fail(f"sinkhorn_v {what} ({tag} rule): max |err| {err} beyond "
                 f"atol {SINKHORN_ATOL} rtol {SINKHORN_RTOL}")
        if not _v_same_bits(logk, u, log_c, rule):
            fail(f"sinkhorn_v {what} ({tag} rule): two launches differ")
        errs[tag] = err
    return errs


def check_v_edges(logk, u, log_c) -> list:
    """The v pass in both rules against its plain version, and to the same
    bits over two launches, on edge inputs cut from a (P, N) problem: every
    width of V_EDGE_WIDTHS at every row count of V_EDGE_ROWS, with
    zero-capacity columns (log_c NEG_INF) in each; at (4097, 130) every
    other row's u NEG_INF, every row's, and every column's capacity zero;
    at (4097, 1024) logk offset by 4 bytes from a 16-byte boundary (scalar
    copies where the aligned row takes 16-byte ones). Returns the cases'
    names."""
    import torch

    from kubernetes_tpu_torch.ops.sinkhorn import NEG_INF

    cases = {}
    for p in V_EDGE_ROWS:
        for n in V_EDGE_WIDTHS:
            lc = log_c[:n].clone()
            lc[::3] = NEG_INF  # zero capacity
            cases[f"{p}x{n}"] = (logk[:p, :n].contiguous(),
                                 u[:p].contiguous(), lc)
    p, n = V_EDGE_ROWS[-1], V_EDGE_WIDTHS[-1]
    lk, ub, lc = cases[f"{p}x{n}"]
    half = ub.clone()
    half[::2] = NEG_INF
    # a row length that takes 16-byte copies when aligned
    wide = logk[:p, :1024]
    buf = torch.empty(wide.numel() + 1, device=lk.device)
    off = buf[1:].view(wide.shape)
    off.copy_(wide)
    cases.update({
        "u_rows_NEG_INF": (lk, half, lc),
        "u_all_NEG_INF": (lk, torch.full_like(ub, NEG_INF), lc),
        "every_capacity_zero": (lk, ub, torch.full_like(lc, NEG_INF)),
        "logk_off_4_bytes": (off, ub, log_c[:1024].contiguous())})
    for name, (a, b, c) in cases.items():
        _v_held(a, b, c, f"edge {name}")
    return sorted(cases)


def time_shard_v(logk, u, log_c, P, n) -> dict:
    """The whole v pass on one shard's (P, n) block, as each shard runs it:
    held against its plain version in both rules and to the same bits over
    two launches, timed warm and with the L2 cold (both rules), beside its
    plain version, ``torch.logsumexp`` and its bound, with ``v_plan``'s
    (lanes, strips, cluster, rows) and the card's resident clusters."""
    import torch

    from kubernetes_tpu_torch.ops import sinkhorn

    errs = _v_held(logk, u, log_c, f"{P}x{n}")

    def kern(rule=False):
        return sinkhorn.sinkhorn_v(logk, u, log_c, rule)

    fit = sinkhorn.v_fit(logk)
    return {"shape": [P, n], "max_abs_err": max(errs.values()),
            "max_abs_err_by_rule": errs,
            "plan": {**dict(zip(("lanes", "strips", "cluster", "rows"),
                                sinkhorn.v_plan(P, n, fit))),
                     "resident_clusters": dict(enumerate(fit, 1))},
            "ms": cuda_time_ms(kern), "device_ms": device_ms(kern),
            "device_ms_cold": cold_ms(kern, TRACE_NAMES["sinkhorn_v"]),
            "jnp_rule": {"device_ms": device_ms(lambda: kern(True)),
                         "device_ms_cold": cold_ms(
                             lambda: kern(True), TRACE_NAMES["sinkhorn_v"])},
            "plain_ms": cuda_time_ms(
                lambda: sinkhorn.sinkhorn_v_plain(logk, u, log_c)),
            "library_ms": cuda_time_ms(
                lambda: torch.logsumexp(logk + u[:, None], 0)),
            **_sinkhorn_bound("sinkhorn_v", P, n)}


def check_split_kernels(out_rows: dict) -> None:
    """The partitioned solve's split kernels against their plain versions
    at (8192, 8192 / d) for d in SPLIT_WIDTHS: the pair's max and scale
    passes bit for bit (and, composed over the d blocks, bit for bit
    against the fused pair), the u pass's (shift, sum) and the merged u
    within the Sinkhorn tolerance in both rules (against the plain merge
    and the whole-row pass), two u launches to the same bits. Timed at
    every width (the row's figures at d = 2, arm E's first mesh) warm and
    with the L2 cold (``device_ms_cold``: the kernel's own trace time,
    each launch after :func:`l2_flush`; the u pass in both rules), each
    beside its plain version and a library call (the pair's max pass:
    ``torch.amax(torch.where(mask, rf, 0), 1)``; the u pass:
    ``torch.logsumexp`` on the block). The whole v pass, which each shard
    runs on its block, is held and timed alike (``shard_widths`` on the v
    row). Then the split kernels on edge inputs."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.ops import fused_score, sinkhorn
    from kubernetes_tpu_torch.parallel import collectives as coll

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261018)
    P, N = 8192, 8192
    rf, rr, mask = _pair_inputs(P, N, gen, dev)
    logk, log_r, log_c, u_in, v = _sinkhorn_inputs(P, N, gen, dev)
    fused = fused_score.fused_pair_normalize(rf, rr, mask, 1.0, 1.0)
    u_whole = {r: sinkhorn.sinkhorn_u_plain(logk, v, log_r, r)
               for r in (False, True)}
    for d in SPLIT_WIDTHS:
        n = N // d
        blk = [(a.contiguous(), b.contiguous(), m.contiguous()) for a, b, m
               in zip(rf.split(n, 1), rr.split(n, 1), mask.split(n, 1))]
        mx = [fused_score.fused_pair_max(*b) for b in blk]
        mx_p = [fused_score.fused_pair_max_plain(*b) for b in blk]
        for (a, b), (c, e) in zip(mx, mx_p):
            if not (torch.equal(a, c) and torch.equal(b, e)):
                fail(f"fused_pair_max {P}x{n}: differs from its plain "
                     "version")
        mxf = torch.stack([m[0] for m in mx]).amax(0)
        mxr = torch.stack([m[1] for m in mx]).amax(0)
        outs = [fused_score.fused_pair_scale(b[0], b[1], mxf, mxr, 1.0, 1.0)
                for b in blk]
        for o, b in zip(outs, blk):
            want = fused_score.fused_pair_scale_plain(b[0], b[1], mxf, mxr,
                                                      1.0, 1.0)
            if not torch.equal(o, want):
                fail(f"fused_pair_scale {P}x{n}: differs from its plain "
                     f"version (max |err| {float((o - want).abs().max())})")
        if not torch.equal(torch.cat(outs, 1), fused):
            fail(f"split pair over {d} shards differs from the fused pair")
        lk = [x.contiguous() for x in logk.split(n, 1)]
        vb = [x.contiguous() for x in v.split(n, 0)]
        errs = {}
        for rule in (False, True):
            parts = [sinkhorn.sinkhorn_u_partial(a, b, rule)
                     for a, b in zip(lk, vb)]
            plain = [sinkhorn.sinkhorn_u_partial_plain(a, b, rule)
                     for a, b in zip(lk, vb)]
            u = coll.lse_combine(torch.stack([p[0] for p in parts]),
                                 torch.stack([p[1] for p in parts]), log_r,
                                 rule)
            u_p = coll.lse_combine(torch.stack([p[0] for p in plain]),
                                   torch.stack([p[1] for p in plain]),
                                   log_r, rule)
            tag = "jnp" if rule else "pallas"
            for got, want, what in ((u, u_p, "merged u"),
                                    (u, u_whole[rule], "u against the "
                                     "whole-row pass")):
                err, ok = sinkhorn_err(got, want)
                if not ok:
                    fail(f"sinkhorn_u_partial {P}x{n} ({tag} rule): {what} "
                         f"max |err| {err} beyond atol {SINKHORN_ATOL} rtol "
                         f"{SINKHORN_RTOL}")
                errs[f"{tag}_{'plain' if want is u_p else 'whole'}"] = err
            for got, want in zip(parts, plain):
                if not _u_partial_agrees(got, want):
                    fail(f"sinkhorn_u_partial {P}x{n} ({tag} rule): "
                         "(shift, sum) beyond tolerance")
            if not _u_partial_same_bits(lk[0], vb[0], rule):
                fail(f"sinkhorn_u_partial {P}x{n} ({tag} rule): two "
                     "launches differ")
        a, b, m = blk[0]
        lk0, vb0 = lk[0], vb[0]

        def pair_max():
            return fused_score.fused_pair_max(a, b, m)

        def pair_scale():
            return fused_score.fused_pair_scale(a, b, mxf, mxr, 1.0, 1.0)

        def u_part(rule=False):
            return sinkhorn.sinkhorn_u_partial(lk0, vb0, rule)

        timed = {
            "fused_pair_max": dict(
                max_abs_err=0.0,
                ms=cuda_time_ms(pair_max), device_ms=device_ms(pair_max),
                device_ms_cold=cold_ms(pair_max,
                                       TRACE_NAMES["fused_pair_max"]),
                plain_ms=cuda_time_ms(
                    lambda: fused_score.fused_pair_max_plain(a, b, m)),
                library_ms=cuda_time_ms(
                    lambda: torch.amax(torch.where(m, a, 0.0), 1))),
            "fused_pair_scale": dict(
                max_abs_err=0.0,
                ms=cuda_time_ms(pair_scale), device_ms=device_ms(pair_scale),
                device_ms_cold=cold_ms(pair_scale,
                                       TRACE_NAMES["fused_pair_scale"]),
                plain_ms=cuda_time_ms(lambda: fused_score
                                      .fused_pair_scale_plain(
                                          a, b, mxf, mxr, 1.0, 1.0)),
                library_ms=None),
            "sinkhorn_u_partial": dict(
                max_abs_err=max(errs.values()),
                max_abs_err_by_rule=errs,
                plan=dict(zip(("warps_a_row", "rows", "blocks"),
                              sinkhorn.u_partial_plan(
                                  P, n, kernels.sm_count(lk0)))),
                ms=cuda_time_ms(u_part), device_ms=device_ms(u_part),
                device_ms_cold=cold_ms(u_part,
                                       TRACE_NAMES["sinkhorn_u_partial"]),
                jnp_rule={"device_ms": device_ms(lambda: u_part(True)),
                          "device_ms_cold": cold_ms(
                              lambda: u_part(True),
                              TRACE_NAMES["sinkhorn_u_partial"])},
                plain_ms=cuda_time_ms(lambda: sinkhorn
                                      .sinkhorn_u_partial_plain(lk0, vb0)),
                library_ms=cuda_time_ms(lambda: torch.logsumexp(
                    lk0 + vb0[None, :], 1))),
        }
        for name, got in timed.items():
            got.update(_split_bound(name, P, n))
            row = out_rows.setdefault(name, {})
            row[f"d{d}"] = {"shape": [P, n], **got}
            if d == SPLIT_WIDTHS[0]:
                row.update(got)
                row["shape"] = [P, n]
        lcb = log_c.split(n, 0)[0].contiguous()
        out_rows.setdefault("sinkhorn_v", {}).setdefault(
            "shard_widths", {})[f"d{d}"] = time_shard_v(lk0, u_in, lcb, P, n)
        del blk, mx, mx_p, outs, lk, vb
        torch.cuda.empty_cache()
    # the split pair takes any row length (a shard's block may be narrower
    # than four columns): scalar reads, same results
    for n in (1, 3, 6):
        a, b, m = (x[:64, :n].contiguous() for x in (rf, rr, mask))
        got = fused_score.fused_pair_max(a, b, m)
        want = fused_score.fused_pair_max_plain(a, b, m)
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            fail(f"fused_pair_max 64x{n}: differs from its plain version")
        o = fused_score.fused_pair_scale(a, b, want[0], want[1], 1.0, 1.0)
        if not torch.equal(o, fused_score.fused_pair_scale_plain(
                a, b, want[0], want[1], 1.0, 1.0)):
            fail(f"fused_pair_scale 64x{n}: differs from its plain version")
    out_rows.setdefault("sinkhorn_u_partial", {})["edge_inputs"] = \
        check_u_partial_edges(logk, v)
    # the v pass at mesh arm E's plan run (4096 pods on 4 shards), then on
    # its edge inputs
    out_rows["sinkhorn_v"]["shard_widths"]["arm_e_plan"] = time_shard_v(
        logk[:4096, :2048].contiguous(), u_in[:4096].contiguous(),
        log_c[:2048].contiguous(), 4096, 2048)
    out_rows["sinkhorn_v"]["edge_inputs"] = check_v_edges(logk, u_in, log_c)
    del rf, rr, mask, logk, log_r, log_c, u_in, v, fused
    torch.cuda.empty_cache()


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
            row["device_ms_cold"] = cold_ms(
                kern, TRACE_NAMES["fused_pair_normalize"])
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
        # -- sinkhorn u / v: within tolerance, in both rules --------------
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
            row = out_rows.setdefault(name, {})
            # the jnp rule (the tolerance loop's): zero-capacity columns
            # (cap 0 in the inputs) keep v near NEG_INF
            got_j = kern(*args, jnp_rule=True)
            want_j = plain(*args, jnp_rule=True)
            torch.cuda.synchronize()
            err_j, ok = sinkhorn_err(got_j, want_j)
            if not ok:
                fail(f"{name} {P}x{N} (jnp rule): max |err| {err_j} beyond "
                     f"atol {SINKHORN_ATOL} rtol {SINKHORN_RTOL}")
            row[f"max_abs_err_{P}x{N}_jnp"] = err_j
            got = kern(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not torch.allclose(got, want, atol=SINKHORN_ATOL,
                                  rtol=SINKHORN_RTOL):
                fail(f"{name} {P}x{N}: max |err| {err} beyond atol "
                     f"{SINKHORN_ATOL} rtol {SINKHORN_RTOL}")
            row[f"max_abs_err_{P}x{N}"] = err
            if i == 0:
                row["max_abs_err"] = err
                row["ms"] = cuda_time_ms(lambda: kern(*args))
                row["ms_batched"] = batched_ms(lambda: kern(*args))
                row["device_ms"] = device_ms(lambda: kern(*args))
                row["device_ms_cold"] = cold_ms(lambda: kern(*args),
                                                TRACE_NAMES[name])
                row["plain_ms"] = cuda_time_ms(lambda: plain(*args))
                row["library_ms"] = cuda_time_ms(lib)
                row.update(_sinkhorn_bound(name, P, N))
        # the v pass gives the same bits run to run in both rules (every
        # merge, across the cluster's blocks too, runs in a fixed order)
        for rule in (False, True):
            if not _v_same_bits(logk, u, log_c, rule):
                fail(f"sinkhorn_v {P}x{N} ({'jnp' if rule else 'pallas'} "
                     "rule): two runs differ")
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
    launch (its first cycle's batch), the v pass at the plan path's; and
    every kernel at every shape the sparse and the serve phase launched
    (the pair bit for bit, u and v in both rules)."""
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
    # the sparse phase's frames: every shape it launched, both arms
    for name, shapes in paths.get("sparse", {}).get("shapes", {}).items():
        if name not in ARRAY_KERNELS:
            continue
        rows = []
        for (P, N), n in shapes:
            got = (time_pair(P, N, gen, dev) if name == "fused_pair_normalize"
                   else time_sinkhorn_pass(name, P, N, gen, dev))
            if name == "fused_pair_normalize":
                got["library_ms"] = None
            rows.append({"shape": [P, N], "launches": n, **got})
            torch.cuda.empty_cache()
        out_rows.setdefault(name, {})["sparse_shapes"] = rows
    # the serve path's micro-batch frames (arms A-D), the hollow
    # cluster's cycles (arms A and B), the recovery cells' (arms A-C),
    # the ledger cell's (arms A-C) and the scenario arms': every kernel at
    # every shape they launched (the pair bit for bit, u and v in both
    # rules), with the wrapper's host share of a single call
    for phase, name, shapes in [
            (phase, name, shapes) for phase in ("serve", "hollow",
                                                "recovery", "ledger",
                                                "scenario")
            for name, shapes in paths.get(phase, {}).get("shapes",
                                                         {}).items()]:
        if name not in ARRAY_KERNELS:
            continue
        rows = []
        for (P, N), n in shapes:
            got = (time_pair(P, N, gen, dev) if name == "fused_pair_normalize"
                   else time_sinkhorn_pass(name, P, N, gen, dev))
            if name == "fused_pair_normalize":
                got["library_ms"] = None
            per_call = got["device_ms"]["per_call"]
            got["host_share"] = (None if per_call is None
                                 else 1.0 - per_call / got["ms"])
            rows.append({"shape": [P, N], "launches": n, **got})
            torch.cuda.empty_cache()
        if rows:
            out_rows.setdefault(name, {})[f"{phase}_shapes"] = rows
    # the mesh phase's shard blocks: the split u pass and the v pass at
    # every shape the phase launched them
    for name in ("sinkhorn_u_partial", "sinkhorn_v"):
        rows = [{"shape": [P, N], "launches": n,
                 **time_shard_pass(name, P, N, gen, dev)}
                for (P, N), n in paths.get("mesh", {}).get("shapes", {})
                .get(name, [])]
        if rows:
            out_rows.setdefault(name, {})["mesh_shapes"] = rows


def time_shard_pass(name, P, N, gen, dev) -> dict:
    """The split u pass or the v pass at one (P, N) shape a shard launched:
    the v pass as :func:`time_shard_v`; the u pass held against its plain
    version in both rules and to the same bits over two launches, then
    its device time warm and with the L2 cold, in the Pallas rule, beside
    its bound."""
    import torch

    from kubernetes_tpu_torch.ops import sinkhorn

    logk, _log_r, log_c, u, v = _sinkhorn_inputs(P, N, gen, dev)
    if name == "sinkhorn_v":
        return time_shard_v(logk, u, log_c, P, N)
    for rule in (False, True):
        got = sinkhorn.sinkhorn_u_partial(logk, v, rule)
        want = sinkhorn.sinkhorn_u_partial_plain(logk, v, rule)
        if not _u_partial_agrees(got, want) or \
                not _u_partial_same_bits(logk, v, rule):
            fail(f"sinkhorn_u_partial {P}x{N} (mesh shape): beyond "
                 "tolerance or two launches differ")

    def kern():
        return sinkhorn.sinkhorn_u_partial(logk, v)

    out = {"device_ms": device_ms(kern),
           "device_ms_cold": cold_ms(kern, TRACE_NAMES[name]),
           **_split_bound(name, P, N)}
    del logk, log_c, u, v
    torch.cuda.empty_cache()
    return out


def launch_counts() -> dict:
    """Each kernel's launches since the last reset, the launches replayed
    inside the device round loop's graph included (read off the device
    counters: one sync, after the run)."""
    from kubernetes_tpu_torch import kernels

    kernels.collect()
    return dict(kernels.LAUNCHES)


def launch_shapes() -> dict:
    """Each kernel's launches since the last reset, by shape, in the
    order of each shape's first launch: ``[[[P, N], launches], ...]``."""
    from kubernetes_tpu_torch import kernels

    kernels.collect()
    return {k: [[list(s), c] for s, c in v.items()]
            for k, v in kernels.SHAPES.items()}


def _bound(nbytes: float, ops: float) -> dict:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / F32_OPS_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


# ---------------------------------------------------------------------------
# phases 3-6: the main path through the port's Scheduler (3 and 5-6),
# and the kernel-route policy on it (4)
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
    launches = launch_counts()
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
    # the convergence stats rode every cycle's solve readback: one sample
    # a cycle, on the flight record and in the two families
    stats = [(rec.sinkhorn_iters, rec.sinkhorn_residual)
             for rec in sched.obs.recorder.records()]
    m = sched.metrics
    if (len(stats) != len(results) or any(i < 0 for i, _ in stats)
            or m.sinkhorn_iterations.count() != len(results)):
        fail(f"plan: Sinkhorn stats {stats}, "
             f"{m.sinkhorn_iterations.count()} samples for {len(results)} "
             "cycles")
    emit({"phase": "plan", "solver": "sinkhorn", "nodes": len(nodes),
          "pending": len(pending), "scheduled": len(assignments),
          "cycle_s": [r.elapsed_s for r in results],
          "rounds": [r.rounds for r in results],
          "host_syncs": [r.host_syncs for r in results],
          "sinkhorn_stats": stats, "launches": launches})
    del sched
    emit({"phase": "plan-stats", **plan_stats_parity()})

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
        got = launch_counts()
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


def plan_stats_parity() -> dict:
    """The plan path reduced (500 nodes, 100 bound, 1024 pending) through
    ``Scheduler(solver="sinkhorn")`` on the card and on CPU tensors: the
    placements equal, ``scheduler_sinkhorn_iterations`` equal sample for
    sample, ``scheduler_sinkhorn_final_residual`` within atol 1e-5 / rtol
    1e-4 (the Sinkhorn tolerance of tests/test_torch_sinkhorn.py)."""
    from kubernetes_tpu_torch.scheduler import Scheduler

    got = {}
    for dev in ("cuda", "cpu"):
        nodes, bound, pending = smoke_cell(500, 100, 1024, seed=3)
        sched = Scheduler(solver="sinkhorn", device=dev)
        results = drive(sched, nodes, bound, pending)
        m = sched.metrics
        got[dev] = ([r.assignments for r in results],
                    m.sinkhorn_iterations.expose(),
                    m.sinkhorn_residual.value())
    (a_c, it_c, res_c), (a_h, it_h, res_h) = got["cuda"], got["cpu"]
    if a_c != a_h:
        fail("plan/stats: the card placed unlike the CPU")
    if it_c != it_h or not it_c:
        fail(f"plan/stats: iterations {it_c} on the card, {it_h} on CPU")
    if abs(res_c - res_h) > 1e-5 + 1e-4 * abs(res_h):
        fail(f"plan/stats: final residual {res_c} on the card, {res_h} on "
             "CPU")
    return {"nodes": 500, "pending": 1024, "cycles": len(a_c),
            "sinkhorn_iterations": it_c[-2:], "residual_cuda": res_c,
            "residual_cpu": res_h, "equal": True}


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
    launches = launch_counts()
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
          "pipeline_chunks": [r.pipeline_chunks for r in results],
          "snapshot_mode": [r.snapshot_mode for r in results],
          "pods_per_s_cycles": scheduled / cycle_s,
          "pods_per_s_wall_with_ingest": scheduled / wall,
          "wall_s_with_ingest": wall, "launches": launches,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "recheck": checked})
    return {"launches": launches, "cycles": len(results), "shapes": shapes}


#: the hand-kernel entries the plain route must not launch
ROUTE_KERNELS = ("fused_pair_normalize", "fused_pair_max", "fused_pair_scale",
                 "sinkhorn_u", "sinkhorn_u_partial", "sinkhorn_v")


@contextlib.contextmanager
def kernel_route(value):
    """``KTPU_PALLAS`` set to ``value`` (None: unset, the default route)
    inside the block, restored after it."""
    old = os.environ.pop("KTPU_PALLAS", None)
    if value is not None:
        os.environ["KTPU_PALLAS"] = value
    try:
        yield
    finally:
        os.environ.pop("KTPU_PALLAS", None)
        if old is not None:
            os.environ["KTPU_PALLAS"] = old


def _route_cycles(sched, nodes, bound, pending):
    """Feed the cluster, then :func:`_mesh_cycles` with the launches and
    the round-loop captures counted from 0. Returns (results, launches,
    captures, wall seconds of the cycles, each cycle's span seconds)."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.ops import device_loop

    feed(sched, nodes, bound, [])
    kernels.reset_launches()
    captures = device_loop.CAPTURES.count
    results, records, wall = _mesh_cycles(sched, pending)
    return (results, launch_counts(), device_loop.CAPTURES.count - captures,
            wall, [_span_sums(rec.spans) for rec in records])


def _tied_tables(dev: str):
    """The tied-preferences workload (a batch the auto-router sends to the
    plan) as device tables on ``dev``: (pods, nodes, selectors, pods)."""
    from kubernetes_tpu_torch.ops.arrays import (
        nodes_to_device,
        pods_to_device,
        selectors_to_device,
    )
    from kubernetes_tpu_torch.snapshot import SnapshotPacker

    t_nodes, t_pods, _points = tied_preferences_workload()
    pk = SnapshotPacker()
    for p in t_pods:
        pk.intern_pod(p)
    return (pods_to_device(pk.pack_pods(t_pods), device=dev),
            nodes_to_device(pk.pack_nodes(t_nodes, []), device=dev),
            selectors_to_device(pk.pack_selector_tables(), device=dev),
            t_pods)


def _tied_route(dev: str) -> dict:
    """The tied-preferences workload through ``batch_assign`` on ``dev``
    under the current route, the default auto-router and a forced plan:
    label -> (placements, Sinkhorn iterations of the last plan round)."""
    from kubernetes_tpu_torch.ops.assign import batch_assign

    dp, dn, ds, t_pods = _tied_tables(dev)
    out = {}
    for label, kw in (("default", {}), ("forced_plan",
                                        {"use_sinkhorn": True})):
        a, _u, _r, stats = batch_assign(dp, dn, ds, per_node_cap=2,
                                        stats_out=True, **kw)
        out[label] = (a.cpu().tolist()[: len(t_pods)],
                      float(stats.cpu()[0]))
    return out


def _zero_capacity_plan(dev: str):
    """A seeded 16 x 8 plan's inputs on ``dev``: columns 0 and 3 at
    capacity 0, every other column at 2, column 0 scoring 5 more than the
    rest (the case where the two routes' rules part)."""
    import numpy as np
    import torch

    g = np.random.default_rng(0)
    score = g.integers(0, 10, (16, 8)).astype(np.float32)
    score[:, 0] += 5
    mask = g.random((16, 8)) < 0.8
    cap = np.full(8, 2, np.float32)
    cap[[0, 3]] = 0
    return tuple(torch.tensor(x, device=dev) for x in (score, mask, cap))


def phase_route() -> dict:
    """The kernel-route policy on the card (``KTPU_PALLAS``, the
    reference's ``use_pallas`` variable). The smoke cell at full width
    through ``Scheduler(device="cuda")`` in two fresh schedulers, the
    variable unset (the deployment default) and ``"1"``: fails unless
    both launch the pair, bind every pod on the batch tier and place
    alike; each arm's cycle seconds are printed. The plain route is
    refused on the card: under ``"0"`` a scheduler on the card, a solve
    on the card's tables and a plan on the card's tensors, and with the
    variable unset ``batch_assign(fused_score=False)`` and
    ``sinkhorn_plan(pallas=False)`` on them, must each raise
    ``PlainRouteRefused`` and launch none of the six hand-kernel entries.
    The unset default is decided per process: a CPU tensor here takes the
    card's route, so the tied-preferences workload (the auto-router plans
    it) places on CPU tensors as on the card, and the seeded
    zero-capacity plan agrees on both within atol 1e-5 / rtol 1e-4.
    Returns the two arms' launches (the phase's path) and cycle count."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.ops.assign import batch_assign
    from kubernetes_tpu_torch.ops.fused_score import (
        PlainRouteRefused,
        use_kernels,
    )
    from kubernetes_tpu_torch.ops.sinkhorn import sinkhorn_plan
    from kubernetes_tpu_torch.scheduler import Scheduler

    t_phase = time.perf_counter()
    warm_up("smoke")
    nodes, bound, pending = smoke_cell()
    by_key = {p.key(): p for p in pending}
    total = {k: 0 for k in kernels.LAUNCHES}
    cycles = 0
    arms = []
    for value in (None, "1"):
        name = "default" if value is None else "kernel"
        with kernel_route(value):
            results, got, captured, wall, spans = _route_cycles(
                Scheduler(device="cuda"), nodes, bound, pending)
        for k in total:
            total[k] += got[k]
        cycles += len(results)
        placed = {k: v for r in results for k, v in r.assignments.items()}
        if len(placed) != len(pending):
            fail(f"route/{name}: bound {len(placed)} of {len(pending)}")
        for r in results:
            if r.solver_tier != "batch" or r.solver_fallbacks:
                fail(f"route/{name}: a cycle solved on tier "
                     f"{r.solver_tier!r} after {r.solver_fallbacks} "
                     "fallbacks")
        if got["fused_pair_normalize"] <= 0:
            fail(f"route/{name}: the kernel route never launched the pair")
        recheck_capacity(nodes, bound, placed, by_key)
        arms.append({"arm": name, "KTPU_PALLAS": value,
                     "cycle_s": [r.elapsed_s for r in results],
                     "solve_s": [r.solve_s for r in results],
                     "rounds": [r.rounds for r in results],
                     "host_syncs": [r.host_syncs for r in results],
                     "wall_s": wall, "graph_captures": captured,
                     "spans": spans,
                     "launches": {k: got[k] for k in ROUTE_KERNELS},
                     "placements": [r.assignments for r in results]})
    if arms[1]["placements"] != arms[0]["placements"]:
        fail("route/kernel: placements differ from the default arm's")
    for arm in arms:
        arm.pop("placements")

    # the plain route on the card: refused at every door, nothing launched
    dp, dn, ds, _t_pods = _tied_tables("cuda")
    plan_in = _zero_capacity_plan("cuda")
    doors = (("0", "scheduler", lambda: Scheduler(device="cuda")),
             ("0", "batch_assign", lambda: batch_assign(dp, dn, ds)),
             ("0", "sinkhorn_plan", lambda: sinkhorn_plan(*plan_in)),
             (None, "fused_score=False",
              lambda: batch_assign(dp, dn, ds, fused_score=False)),
             (None, "pallas=False",
              lambda: sinkhorn_plan(*plan_in, pallas=False)))
    kernels.reset_launches()
    refused = []
    for value, door, call in doors:
        with kernel_route(value):
            try:
                call()
            except PlainRouteRefused as e:
                refused.append({"door": door, "KTPU_PALLAS": value,
                                "error": str(e)[:160]})
                continue
        fail(f"route/plain: {door} (KTPU_PALLAS={value or 'unset'}) took "
             "the plain route on the card")
    got = launch_counts()
    if any(got[k] for k in ROUTE_KERNELS):
        fail(f"route/plain: a refused call launched kernels {got}")

    # unset, decided per process: a CPU tensor takes the card's route
    with kernel_route(None):
        if not use_kernels("cpu"):
            fail("route: a CPU tensor beside the card left the card's route")
        kernels.reset_launches()
        tied = {dev: _tied_route(dev) for dev in ("cuda", "cpu")}
        got = launch_counts()
        plans = {dev: sinkhorn_plan(*_zero_capacity_plan(dev)).cpu()
                 for dev in ("cuda", "cpu")}
    if not got["sinkhorn_u"] or not got["sinkhorn_v"]:
        fail(f"route/tied: the card's plan ran no u or v kernel ({got})")
    for label in tied["cuda"]:
        (a_gpu, it_gpu), (a_cpu, it_cpu) = (tied["cuda"][label],
                                            tied["cpu"][label])
        # the kernels sum in another order: the first converged
        # iteration may fall one apart at the tolerance's edge
        if a_gpu != a_cpu or it_gpu < 0 or abs(it_gpu - it_cpu) > 1:
            fail(f"route/tied {label}: the card placed unlike the CPU "
                 f"({tied})")
    zc_err = float((plans["cuda"] - plans["cpu"]).abs().max())
    if not torch.allclose(plans["cuda"], plans["cpu"], atol=1e-5,
                          rtol=1e-4) or not torch.equal(
                              plans["cuda"].argmax(1),
                              plans["cpu"].argmax(1)):
        fail(f"route/zero-capacity plan: card and CPU differ ({zc_err})")
    for arm in arms:
        print(f"chip_smoke: route {arm['arm']} (KTPU_PALLAS="
              f"{arm['KTPU_PALLAS'] or 'unset'}): cycle seconds "
              f"{arm['cycle_s']}", flush=True)
    emit({"phase": "route", "cell": "smoke-5k-prefaffinity",
          "nodes": len(nodes), "bound": len(bound),
          "pending": len(pending), "arms": arms, "refused": refused,
          "tied": {"equal_to_cpu": True,
                   "sinkhorn_iterations": {
                       k: [tied["cuda"][k][1], tied["cpu"][k][1]]
                       for k in tied["cuda"]}},
          "zero_capacity_plan_max_abs_err": zc_err,
          "seconds": time.perf_counter() - t_phase})
    return {"launches": total, "cycles": cycles}


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
    # the sparsity-first routes, reduced: 1000 nodes, C = 64 (16 blocks
    # of the padded 1024, capped at 8), a 512-pod burst, 8 micro-batches
    out = {}
    for dev in ("cuda", "cpu"):
        results, _walls, _cell, _final, _declines = run_sparse(
            "batch", device=dev, candidate_bucket=64, n_nodes=1000,
            n_bound=200, burst=512, steady=8, seed=11, batches=(8, 16, 32))
        out[dev] = [(r.solve_scope, r.rounds, r.assignments)
                    for r in results]
    if out["cuda"] != out["cpu"]:
        fail("parity sparse-5k-churn (reduced): CUDA and CPU differ "
             f"(scopes {[x[0] for x in out['cuda']]} vs "
             f"{[x[0] for x in out['cpu']]})")
    emit({"phase": "parity", "cell": "sparse-5k-churn", "nodes": 1000,
          "candidate_bucket": 64, "burst": 512, "micro_batches": 8,
          "scopes": [x[0] for x in out["cuda"]],
          "rounds": [x[1] for x in out["cuda"]], "identical": True})


# ---------------------------------------------------------------------------
# phase 8: preemption, nominated pods and the explain report
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
    launches = launch_counts()
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
# phase 9: the sparsity-first routes (restricted, partitioned, warm Sinkhorn)
# ---------------------------------------------------------------------------

#: micro-batch sizes the steady cycles cycle through (128 = max_batch_frac
#: x C at C = 256)
SPARSE_BATCHES = (16, 32, 64, 128)


def sparse_traffic(n_nodes=5000, n_bound=1000, burst=4096, steady=48,
                   seed=7, batches=SPARSE_BATCHES):
    """Cell ``sparse-5k-churn``: the smoke cell's cluster and pods (4 CPU
    / 32 Gi / 110-pod nodes over 10 zones, the autoscaler's
    PreferNoSchedule taint on every 10th node, 100m / 500 Mi pods with a
    weight-50 preferred zone, half tolerating the taint), seeded. Cycle 1
    takes a cold burst of ``burst`` pods; then ``steady`` cycles each
    delete 8 seeded bound pods and add a micro-batch of 16, 32, 64, 128,
    ... (``batches``); the middle steady cycle also adds a node; the last
    adds 15
    ordinary pods and one pod that fits nowhere (64 CPU). Returns
    ``(nodes, bound, cycles, expected scopes, misfit)`` with ``cycles`` a
    list of ``(nodes to add, pods to add, bound-pod deletes)``."""
    import random

    from kubernetes_tpu_torch.api.types import Toleration
    from kubernetes_tpu_torch.testing import (
        make_node,
        make_pod,
        node_affinity_preferred,
        req,
    )

    rng = random.Random(seed)
    nodes, bound, _pending = smoke_cell(n_nodes=n_nodes, n_bound=n_bound,
                                        n_pending=0)
    tol = (Toleration(key=SOFT_TAINT, operator="Exists",
                      effect="PreferNoSchedule"),)
    count = [0]

    def pods(n):
        out = []
        for _ in range(n):
            i = count[0]
            count[0] += 1
            out.append(make_pod(
                f"sp-{i}", cpu_milli=100, memory=500 * 2**20,
                affinity=node_affinity_preferred(
                    (50, [req(ZONE, "In", f"zone-{rng.randrange(10)}")])),
                tolerations=tol if i % 2 else ()))
        return out

    node_add_at = steady // 2
    cycles = [([], pods(burst), 0)]
    scopes = ["partitioned"]
    misfit = make_pod("sp-misfit", cpu_milli=64000, memory=500 * 2**20)
    for c in range(steady):
        if c == steady - 1:
            cycles.append(([], pods(15) + [misfit], 8))
            scopes.append("full")
            continue
        add = []
        if c == node_add_at:
            add = [make_node(f"node-{n_nodes}", cpu_milli=4000,
                             memory=32 * 2**30, pods=110,
                             zone=f"zone-{n_nodes % 10}")]
        cycles.append((add, pods(batches[c % len(batches)]), 8))
        scopes.append("partitioned" if add else "restricted")
    return nodes, bound, cycles, scopes, misfit


def _route_declines():
    """A logging handler that keeps the port's warnings of a declined
    restricted or partitioned solve (a fault inside the route; an
    under-placed attempt falls back without one)."""
    import logging

    class Declines(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.messages = []

        def emit(self, record):
            msg = record.getMessage()
            if "declined" in msg:
                self.messages.append(msg)

    return Declines()


def run_sparse(solver, device="cuda", candidate_bucket=256, keep=None,
               **traffic):
    """Drive ``sparse_traffic`` through ``Scheduler(device=..., incremental=
    IncrementalConfig(enabled=True, primary=True, ...))`` with preemption
    off (the sinkhorn arm with warm potentials at tolerance 1e-3). Every
    bind is confirmed by the watch's add right after its cycle, as the
    API server would. Returns ``(results, wall seconds per cycle, the
    cell, the final pod -> node map, the routes' decline warnings)``;
    ``keep`` (a dict) receives the scheduler under ``"sched"``."""
    import logging
    import random

    import torch

    from kubernetes_tpu_torch.config import IncrementalConfig
    from kubernetes_tpu_torch.scheduler import Scheduler

    inc = IncrementalConfig(enabled=True, primary=True,
                            candidate_bucket=candidate_bucket,
                            warm_potentials=True, warm_tol=1e-3)
    # the scheduler's clock is perf_counter, so that CycleResult.solve_s
    # is on the same clock as the cycle walls measured here
    sched = Scheduler(device=device, solver=solver, enable_preemption=False,
                      incremental=inc, clock=time.perf_counter)
    if keep is not None:
        keep["sched"] = sched
    cell = sparse_traffic(**traffic)
    nodes, bound, cycles, _scopes, _misfit = cell
    for nd in nodes:
        sched.on_node_add(nd)
    placed = {}  # pod key -> bound pod (node_name set)
    for p in bound:
        sched.on_pod_add(p)
        placed[p.key()] = p
    rng = random.Random(11)
    results, walls = [], []
    on_card = torch.device(device).type == "cuda"
    declines = _route_declines()
    port_log = logging.getLogger("kubernetes_tpu_torch")
    port_log.addHandler(declines)
    try:
        _drive_sparse(sched, cycles, placed, rng, results, walls, on_card)
    finally:
        port_log.removeHandler(declines)
    return (results, walls, cell, {k: p.node_name for k, p in placed.items()},
            declines.messages)


def sparse_families(solver, sched, results) -> dict:
    """The incremental families (and, on the sinkhorn arm, the Sinkhorn
    ones) have the samples the run's cycles give them: one count per
    cycle by its solve scope, the reuse gauge at the last cycle's
    fraction, the warm state's drops counted. Returns their samples."""
    m = sched.metrics
    scopes: dict = {}
    for r in results:
        scopes[r.solve_scope] = scopes.get(r.solve_scope, 0) + 1
    for scope, n in scopes.items():
        if m.incremental_cycles.value(scope=scope) != n:
            fail(f"sparse/{solver}: scheduler_incremental_cycles_total"
                 f"{{scope={scope!r}}} is not its {n} cycles")
    if m.incremental_reuse_fraction.value() != results[-1].reuse_frac:
        fail(f"sparse/{solver}: the reuse gauge reads "
             f"{m.incremental_reuse_fraction.value()}")
    out = {"incremental_cycles": m.incremental_cycles.expose(),
           "incremental_invalidations":
           m.incremental_invalidations.expose()}
    if not out["incremental_invalidations"]:
        fail(f"sparse/{solver}: the node add dropped no warm state")
    if solver == "sinkhorn":
        out["sinkhorn_iterations_count"] = m.sinkhorn_iterations.count()
        out["sinkhorn_final_residual"] = m.sinkhorn_residual.value()
        if not out["sinkhorn_iterations_count"]:
            fail("sparse/sinkhorn: no Sinkhorn convergence sample")
    return out


def _drive_sparse(sched, cycles, placed, rng, results, walls, on_card):
    """The cycles of :func:`run_sparse` (appends to ``results``/``walls``
    and keeps ``placed`` as the watch would see it)."""
    import dataclasses

    import torch

    for add, pending, deletes in cycles:
        for nd in add:
            sched.on_node_add(nd)
        for key in rng.sample(sorted(placed), deletes):
            sched.on_pod_delete(placed.pop(key))
        for p in pending:
            sched.on_pod_add(p)
        by_key = {p.key(): p for p in pending}
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = sched.schedule_cycle()
        if on_card:
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        results.append(r)
        for key, node in r.assignments.items():
            p = dataclasses.replace(by_key[key], node_name=node)
            sched.on_pod_add(p)  # the watch confirms the binding
            placed[key] = p


def _by_scope(results, values):
    out: dict = {}
    for r, v in zip(results, values):
        out.setdefault(r.solve_scope, []).append(v)
    return out


def phase_sparse() -> dict:
    """Cell ``sparse-5k-churn`` on both arms (``solver="batch"``, and
    ``solver="sinkhorn"`` with warm potentials), each on a fresh cluster
    after the same sequence on a 600-node cell off the clock. Fails unless
    every pod that fits binds, the capacity re-check is clean, the scope
    sequence is exactly the traffic's (partitioned, restricted...,
    partitioned after the node add, full on the under-placed cycle: a
    restricted or partitioned attempt declined by a fault would show here
    as another scope, and its warning is counted), every cycle solved on
    its arm's tier with no
    fallback, the pair kernel launched on both arms and u and v on the
    sinkhorn arm. Returns the launches of both arms' full-width runs,
    their cycle count and the shapes launched."""
    import torch

    from kubernetes_tpu_torch import kernels

    total: dict = {k: 0 for k in kernels.LAUNCHES}
    shapes: dict = {}
    cycles = 0
    for solver in ("batch", "sinkhorn"):
        run_sparse(solver, n_nodes=600, n_bound=120, burst=512, steady=8,
                   seed=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        box: dict = {}
        results, walls, cell, final, declines = run_sparse(solver, keep=box)
        torch.cuda.synchronize()
        families = sparse_families(solver, box.pop("sched"), results)
        launches = launch_counts()
        arm_shapes = launch_shapes()
        nodes, bound, traffic, want_scopes, misfit = cell
        if declines:
            fail(f"sparse/{solver}: a route declined on a fault and "
                 f"re-solved dense: {declines[:3]}")
        scopes = [r.solve_scope for r in results]
        if scopes != want_scopes:
            fail(f"sparse/{solver}: scopes {scopes} != {want_scopes}")
        for r in results:
            if r.solver_tier != solver or r.solver_fallbacks:
                fail(f"sparse/{solver}: a cycle solved on tier "
                     f"{r.solver_tier!r} after {r.solver_fallbacks} "
                     "fallbacks")
        pending = [p for _a, ps, _d in traffic for p in ps]
        bound_n = sum(r.scheduled for r in results)
        if bound_n != len(pending) - 1:
            fail(f"sparse/{solver}: bound {bound_n} of {len(pending) - 1} "
                 "pods that fit")
        last = results[-1]
        if (last.unschedulable != 1 or misfit.key() not in last.fit_errors
                or "Insufficient cpu" not in last.fit_errors[misfit.key()]):
            fail(f"sparse/{solver}: the misfit pod did not fail with its "
                 f"FitError ({last.fit_errors})")
        all_nodes = nodes + [nd for add, _p, _d in traffic for nd in add]
        by_key = {p.key(): p for p in bound + pending}
        recheck_capacity(all_nodes, [], final, by_key)
        if launches["fused_pair_normalize"] <= 0:
            fail(f"sparse/{solver}: the fused-pair kernel never launched")
        if solver == "sinkhorn" and (launches["sinkhorn_u"] <= 0
                                     or launches["sinkhorn_v"] <= 0):
            fail(f"sparse/sinkhorn: Sinkhorn kernels not launched "
                 f"({launches})")
        steady = [i for i, r in enumerate(results)
                  if i > 0 and r.solve_scope == "restricted"]
        emit({"phase": "sparse", "cell": "sparse-5k-churn",
              "solver": solver, "nodes": len(all_nodes),
              "bound": len(bound), "pending": len(pending),
              "scheduled": bound_n, "cycles": len(results),
              "cycles_by_scope": {k: len(v) for k, v in _by_scope(
                  results, results).items()},
              "scopes": scopes,
              "snapshot_mode": [r.snapshot_mode for r in results],
              "attempted": [r.attempted for r in results],
              "rounds_by_scope": _by_scope(results,
                                           [r.rounds for r in results]),
              "host_syncs_by_scope": _by_scope(
                  results, [r.host_syncs for r in results]),
              "cycle_s_by_scope": _by_scope(results, walls),
              "solve_s_by_scope": _by_scope(results,
                                            [r.solve_s for r in results]),
              "reuse_frac": [r.reuse_frac for r in results],
              "cold_blocks": [r.cold_blocks for r in results],
              "route_declines": len(declines),
              "pods_per_s_steady": (
                  sum(results[i].scheduled for i in steady)
                  / sum(walls[i] for i in steady)),
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
              "launches": launches, "shapes": {
                  k: v for k, v in arm_shapes.items() if v},
              "metric_families": families,
              "recheck": "capacity clean"})
        for k, v in launches.items():
            total[k] += v
        for k, v in arm_shapes.items():
            got = shapes.setdefault(k, [])
            for shape, n in v:
                for row in got:
                    if row[0] == shape:
                        row[1] += n
                        break
                else:
                    got.append([shape, n])
        cycles += len(results)
        torch.cuda.empty_cache()
    return {"launches": total, "cycles": cycles, "shapes": shapes}


# ---------------------------------------------------------------------------
# phase 10: the pipelined cycle executor and the device round loop
# ---------------------------------------------------------------------------


def pipeline_cell(n_nodes=5000, n_bound=1000, n_pending=30000, seed=7):
    """Cell ``pipeline-5k-30k``: the reference bench's headline shape
    (``bench.py:32-38``, BenchmarkScheduling's 5000 nodes, 1000 bound and
    30,000 pending, in batches of 8192) with the smoke cell's nodes and
    pods. At the defaults every cycle pipelines: 4 cycles of 8192, 8192,
    8192 and 5424 pods, each in 2 chunks of at most 4096."""
    return smoke_cell(n_nodes, n_bound, n_pending, seed)


class DispatchCheck:
    """Wraps a scheduler's tier runs (the pipelined executor's dispatch):
    each runs under ``torch.cuda.set_sync_debug_mode("error")``, so a
    device-to-host sync that does not go through the counted ``to_host``
    raises; the counted reads (the auto-router's decisions) are recorded
    per run, and the first run's inputs are kept."""

    def __init__(self, sched) -> None:
        self.reads: list = []
        self.inputs = None
        real = sched._run_tier

        def run(tier, batch, *args):
            import torch

            from kubernetes_tpu_torch.ops.sync import SYNCS

            if self.inputs is None:
                self.inputs = args
            s0 = SYNCS.count
            torch.cuda.set_sync_debug_mode("error")
            try:
                return real(tier, batch, *args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                self.reads.append(SYNCS.count - s0)

        sched._run_tier = run


def feed(sched, nodes, bound, pending) -> None:
    for nd in nodes:
        sched.on_node_add(nd)
    for p in bound + pending:
        sched.on_pod_add(p)


def busy_share(prof, wall_s: float) -> dict:
    """Device busy seconds of a profiled window (the union of the card's
    kernel, copy and fill intervals) and its share of ``wall_s``."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for t0, t1 in spans:
        busy_us += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return {"device_events": len(spans), "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall_s,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall_s}


def _span_sums(durations: dict) -> dict:
    """Host seconds of the pipelined executor's span kinds in one cycle
    (``pack``, ``dispatch``, ``readback``, ``bind``, summed over chunks)
    and of the cycle's other top-level spans, from the cycle trace's
    ``span_durations()``."""
    out: dict = {}
    for name, sec in durations.items():
        key = name.split("@")[0].replace("pipeline:", "")
        out[key] = out.get(key, 0.0) + sec
    return out


def run_pipeline(depth: int, cell=None, chunk: int = 4096, device="cuda",
                 check: bool = True, facade: list = None, **kw):
    """One run of the cell through ``Scheduler(device=..., pipeline_depth=
    depth, pipeline_chunk=chunk, **kw)`` until the queue drains. Returns
    the per-cycle results, the router reads per cycle and the dispatch
    check. With ``facade`` (a list), every whole cycle runs under
    ``torch.cuda.set_sync_debug_mode("error")`` and ``facade`` receives,
    per cycle, the observability facade's flight record (None when it
    recorded none), its trace's spans and the bytes ``ops/sync.to_host``
    moved in the cycle."""
    import torch

    from kubernetes_tpu_torch.ops.sync import SYNCS
    from kubernetes_tpu_torch.scheduler import Scheduler

    nodes, bound, pending = cell if cell is not None else pipeline_cell()
    sched = Scheduler(device=device, pipeline_depth=depth,
                      pipeline_chunk=chunk, **kw)
    dc = DispatchCheck(sched) if check else None
    feed(sched, nodes, bound, pending)
    results, reads = [], []
    for _ in range(16):
        n0 = len(dc.reads) if dc else 0
        n_rec = sched.obs.recorder.recorded
        moved = SYNCS.d2h_bytes
        if facade is not None:
            torch.cuda.set_sync_debug_mode("error")
        try:
            r = sched.schedule_cycle()
        finally:
            if facade is not None:
                torch.cuda.set_sync_debug_mode(0)
        if r.attempted == 0:
            break
        results.append(
            (r, _span_sums(sched.obs.last_trace.span_durations())))
        reads.append(sum(dc.reads[n0:]) if dc else 0)
        if facade is not None:
            rec = (sched.obs.recorder.records()[-1]
                   if sched.obs.recorder.recorded > n_rec else None)
            facade.append((rec, sched.obs.last_trace.span_durations(),
                           SYNCS.d2h_bytes - moved))
    return results, reads, dc


def check_facade(tag: str, results, facade) -> dict:
    """The observability facade on a pipelined run: one flight record per
    eventful cycle, its spans the cycle trace's, its readback bytes the
    bytes ``to_host`` moved in the cycle, no signature retrace and no
    graph capture after the first cycle. Returns the summary."""
    for k, ((r, _), (rec, spans, moved)) in enumerate(zip(results, facade)):
        if rec is None:
            fail(f"{tag}: cycle {k + 1} left no flight record")
        if rec.spans != spans:
            fail(f"{tag}: cycle {k + 1}'s record spans {sorted(rec.spans)} "
                 f"differ from its trace's {sorted(spans)}")
        if rec.readback_bytes != moved:
            fail(f"{tag}: cycle {k + 1} records {rec.readback_bytes} "
                 f"readback bytes, to_host moved {moved}")
        if (rec.attempted, rec.scheduled, rec.tier) != (
                r.attempted, r.scheduled, r.solver_tier):
            fail(f"{tag}: cycle {k + 1}'s record disagrees with its result")
        if k and (rec.retraces or r.graph_captures):
            fail(f"{tag}: cycle {k + 1}: {rec.retraces} retraces, "
                 f"{r.graph_captures} graph captures after the first cycle")
    return {"records": len(facade),
            "readback_bytes": [rec.readback_bytes for rec, _, _ in facade],
            "retraces": [rec.retraces for rec, _, _ in facade],
            "batch_shapes": sorted({rec.batch_shape for rec, _, _ in facade}),
            "whole_cycle_sync_debug": "error"}


def phase_pipeline() -> dict:
    """Drives cell ``pipeline-5k-30k`` at full width at depth 2 (the
    default) and at depth 1, then one profiled pipelined cycle, the
    full node-table upload timed pinned and blocking
    (:func:`time_full_upload`), then a reduced run at depths 2 and 3 on
    the card and on CPU tensors. Fails
    unless every pod binds on tier ``batch``, the capacity re-check holds,
    every chunk's dispatch runs clean under sync-debug ``error``, each
    cycle's host syncs are no more than its chunks plus its explain
    readbacks plus its router decisions, and the reduced runs place
    identically. Returns the depth-2 run's kernel launches, its cycle
    count and its first dispatch's inputs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kubernetes_tpu_torch import kernels

    # warm the libraries and this path off the clock (600 pods in chunks
    # of 256)
    run_pipeline(2, pipeline_cell(100, 20, 600, seed=1), chunk=256)
    torch.cuda.synchronize()
    out = {}
    for depth in (2, 1):
        cell = pipeline_cell()
        torch.cuda.synchronize()
        kernels.reset_launches()
        facade = [] if depth == 2 else None
        results, reads, dc = run_pipeline(depth, cell, facade=facade)
        torch.cuda.synchronize()
        launches = launch_counts()
        shapes = launch_shapes()
        nodes, bound, pending = cell
        rs = [r for r, _ in results]
        scheduled = sum(r.scheduled for r in rs)
        if scheduled != len(pending):
            fail(f"pipeline/depth {depth}: bound {scheduled} of "
                 f"{len(pending)} pods")
        for r, n_reads in zip(rs, reads):
            if r.solver_tier != "batch" or r.solver_fallbacks:
                fail(f"pipeline/depth {depth}: a cycle solved on tier "
                     f"{r.solver_tier!r} after {r.solver_fallbacks} "
                     "fallbacks")
            chunks = max(r.pipeline_chunks, 1)
            # a chunk with failures reads its explain rows and, for
            # preemption, its reason rows
            explain_reads = 2 * chunks if r.unschedulable else 0
            if r.host_syncs > chunks + explain_reads + n_reads:
                fail(f"pipeline/depth {depth}: {r.host_syncs} host syncs "
                     f"in a cycle of {chunks} chunks and {n_reads} router "
                     "decisions")
        want_chunks = [2, 2, 2, 2] if depth == 2 else [0, 0, 0, 0]
        if [r.pipeline_chunks for r in rs] != want_chunks or [
                r.attempted for r in rs] != [8192, 8192, 8192, 5424]:
            fail(f"pipeline/depth {depth}: cycles "
                 f"{[r.attempted for r in rs]} in chunks "
                 f"{[r.pipeline_chunks for r in rs]}")
        assignments = {}
        for r in rs:
            assignments.update(r.assignments)
        recheck_capacity(nodes, bound, assignments,
                         {p.key(): p for p in pending})
        cycle_s = [r.elapsed_s for r in rs]
        out[depth] = {
            "depth": depth, "cycles": len(rs),
            "attempted": [r.attempted for r in rs],
            "pipeline_chunks": [r.pipeline_chunks for r in rs],
            "cycle_s": cycle_s, "solve_s": [r.solve_s for r in rs],
            "rounds": [r.rounds for r in rs],
            "host_syncs": [r.host_syncs for r in rs],
            "router_reads": reads,
            "spans_s": [sp for _, sp in results],
            "pods_per_s": scheduled / sum(cycle_s),
            # without the first cycle, which captures the round loop
            "pods_per_s_warm": (sum(r.scheduled for r in rs[1:])
                                / sum(cycle_s[1:])),
        }
        if depth == 2:
            main = {"launches": launches, "cycles": len(rs),
                    "shapes": shapes, "inputs": dc.inputs}
            out[depth]["facade"] = check_facade("pipeline/depth 2",
                                                results, facade)
            facade_on = rs
        emit({"phase": "pipeline", "cell": "pipeline-5k-30k",
              "nodes": len(nodes), "bound": len(bound),
              "pending": len(pending), "scheduled": scheduled,
              "recheck": "capacity clean", "dispatch_sync_debug": "error",
              "launches": launches, **out[depth]})
        del cell, results, dc
        torch.cuda.empty_cache()

    # the facade's host cost: the depth-2 run again with the flight
    # recorder, the trace ring, the journeys and the three device backends
    # (the perf and memory ledgers, the incident recorder) off; its
    # placements and syncs must be the facade-on run's
    from kubernetes_tpu_torch.config import (
        IncidentsConfig,
        JourneysConfig,
        LedgerConfig,
        MemoryLedgerConfig,
        ObservabilityConfig,
    )

    off = ObservabilityConfig(enabled=False,
                              journeys=JourneysConfig(enabled=False),
                              ledger=LedgerConfig(enabled=False),
                              memory_ledger=MemoryLedgerConfig(enabled=False),
                              incidents=IncidentsConfig(enabled=False))
    results, _reads, _dc = run_pipeline(2, pipeline_cell(),
                                        observability=off)
    rs_off = [r for r, _ in results]
    # and on again, so the two settings alternate (on, off, on)
    again, _reads, _dc = run_pipeline(2, pipeline_cell())
    rs_again = [r for r, _ in again]
    if [r.assignments for r in rs_again] != [r.assignments
                                              for r in facade_on]:
        fail("pipeline/facade on again: placements differ from the first "
             "facade-on run's")
    if [r.assignments for r in rs_off] != [r.assignments
                                            for r in facade_on]:
        fail("pipeline/facade off: placements differ from the facade-on "
             "run's")
    if [r.host_syncs for r in rs_off] != [r.host_syncs for r in facade_on]:
        fail(f"pipeline/facade: host syncs {[r.host_syncs for r in facade_on]}"
             f" with the facade, {[r.host_syncs for r in rs_off]} without")
    emit({"phase": "pipeline-facade", "cell": "pipeline-5k-30k",
          "depth": 2, "cycle_s_facade_on": [r.elapsed_s for r in facade_on],
          "cycle_s_facade_off": [r.elapsed_s for r in rs_off],
          "cycle_s_facade_on_again": [r.elapsed_s for r in rs_again],
          "spans_s_facade_on_again": [sp for _, sp in again],
          "spans_s_facade_on": out[2]["spans_s"],
          "spans_s_facade_off": [sp for _, sp in results],
          "host_syncs_facade_off": [r.host_syncs for r in rs_off]})
    del results, rs_off, facade_on, again, rs_again

    # one pipelined cycle under the profiler (the second: the first
    # captures the round loop)
    from kubernetes_tpu_torch.scheduler import Scheduler

    sched = Scheduler(device="cuda")
    feed(sched, *pipeline_cell())
    sched.schedule_cycle()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = sched.schedule_cycle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    got = busy_share(prof, wall)
    if not got["device_events"]:
        fail("pipeline: the profiled cycle holds no device events")
    emit({"phase": "pipeline-profile", "cell": "pipeline-5k-30k",
          "cycle": 2, "scheduled": r.scheduled,
          "pipeline_chunks": r.pipeline_chunks, "rounds": r.rounds,
          "host_syncs": r.host_syncs, "wall_s_profiled": wall,
          "spans_s": _span_sums(sched.obs.last_trace.span_durations()),
          **got})
    emit({"phase": "pipeline-upload", "cell": "pipeline-5k-30k",
          **time_full_upload(sched.cache.device_snapshot()[0])})
    del sched, prof
    torch.cuda.empty_cache()

    # reduced: 500 nodes, 3000 pods in chunks of 512 -- depth 2 and 3 on
    # the card and depth 2 on CPU tensors place identically
    placed = {}
    for label, depth, dev in (("cuda/2", 2, "cuda"), ("cuda/3", 3, "cuda"),
                              ("cpu/2", 2, "cpu")):
        results, _reads, _dc = run_pipeline(
            depth, pipeline_cell(500, 100, 3000, seed=11), chunk=512,
            device=dev, check=dev == "cuda")
        placed[label] = [(r.assignments, r.rounds, r.pipeline_chunks)
                         for r, _ in results]
    if not placed["cuda/2"] == placed["cuda/3"] == placed["cpu/2"]:
        fail("pipeline (reduced): depth 2, depth 3 and CPU placements differ")
    emit({"phase": "pipeline-parity", "nodes": 500, "pending": 3000,
          "pipeline_chunk": 512,
          "chunks": [c for _a, _r, c in placed["cuda/2"]],
          "rounds": [r for _a, r, _c in placed["cuda/2"]],
          "identical": ["cuda/2", "cuda/3", "cpu/2"]})
    return main


def time_full_upload(table, reps: int = 10) -> dict:
    """Host milliseconds of one full node-table upload (``nodes_to_device``
    to the card, then a synchronize), medians over ``reps`` alternating
    runs of the two copies: the port's ``ops/arrays.upload`` (staged in
    pinned memory, enqueued non-blocking) and a blocking
    ``torch.tensor(..., device="cuda")`` per field."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.cache import tree_nbytes
    from kubernetes_tpu_torch.ops import arrays
    from kubernetes_tpu_torch.utils.interner import bucket_size

    pinned = arrays.upload

    def blocking(a, device, dtype=None):
        return torch.tensor(np.asarray(a, dtype=dtype), device=device)

    pad = bucket_size(max(table.n, 1))
    times: dict = {"pinned": [], "blocking": []}
    nbytes = 0
    try:
        for _ in range(reps):
            for name, fn in (("pinned", pinned), ("blocking", blocking)):
                arrays.upload = fn
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dev = arrays.nodes_to_device(table, pad_to=pad,
                                             device="cuda")
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
                nbytes = tree_nbytes(dev)
                del dev
    finally:
        arrays.upload = pinned
    return {"rows": table.n, "padded_rows": pad, "bytes": nbytes,
            **{f"{k}_ms": _pct(v, 50) for k, v in times.items()},
            **{f"{k}_ms_all": v for k, v in times.items()}}


@contextlib.contextmanager
def host_round_loop():
    """Inside the block, the round loop runs as the plain Python loop
    even on CUDA tensors (the device loop's plain version)."""
    from kubernetes_tpu_torch.ops import device_loop

    real = device_loop.run

    def plain(fn, ctx, state, valid, max_rounds, statics=None, shape=()):
        return real(fn, ctx, state, valid, max_rounds, None, shape)

    device_loop.run = plain
    try:
        yield
    finally:
        device_loop.run = real


def _nbytes(*trees) -> int:
    import torch

    total = 0
    for tree in trees:
        if isinstance(tree, torch.Tensor):
            total += tree.numel() * tree.element_size()
        elif isinstance(tree, (tuple, list)):
            total += _nbytes(*tree)
    return total


def check_round_loop(out_rows: dict, inputs) -> None:
    """The device round loop held against its plain version (the Python
    loop on the same CUDA tensors) on the pipeline path's first chunk:
    placements, usage and round count must be identical. Times both
    (CUDA events around one ``batch_assign``)."""
    import torch

    from kubernetes_tpu_torch.ops.assign import batch_assign

    (dp, dn, ds, dt, dv, sv, _base_fr, extra_mask, extra_score, skip,
     no_ports, no_aff, no_spread) = inputs

    def solve():
        return batch_assign(dp, dn, ds, None, max_rounds=128,
                            per_node_cap=4, topo=dt, extra_mask=extra_mask,
                            vol=dv, static_vol=sv, extra_score=extra_score,
                            skip_priorities=skip, no_ports=no_ports,
                            no_pod_affinity=no_aff, no_spread=no_spread)

    a, u, rounds = solve()
    with host_round_loop():
        a2, u2, rounds2 = solve()
    torch.cuda.synchronize()
    err = max(float((a - a2).abs().max()),
              float((u.requested - u2.requested).abs().max()),
              abs(int(rounds) - int(rounds2)))
    if err or not torch.equal(a, a2):
        fail(f"round_loop: the device loop differs from the Python loop "
             f"(max |err| {err}, rounds {int(rounds)} vs {int(rounds2)})")
    row = out_rows.setdefault("round_loop", {})
    P, N = dp.valid.shape[0], dn.valid.shape[0]
    row["max_abs_err"] = err
    row["shape"] = [P, N]
    row["rounds"] = int(rounds)
    row["ms"] = cuda_time_ms(solve)
    row["device_ms"] = device_ms(solve)["per_call"]
    with host_round_loop():
        row["plain_ms"] = cuda_time_ms(solve)
        row["plain_device_ms"] = device_ms(solve)["per_call"]
    # no PyTorch call runs a data-dependent loop on the card
    row["library_ms"] = None
    # the least the loop could move: its inputs read once, its outputs
    # (assignment and usage) written once
    row.update(_bound(_nbytes(tuple(dp), tuple(dn), tuple(ds), a, tuple(u)),
                      0.0))


# ---------------------------------------------------------------------------
# phase 11: the configured scheduler (Scheduler.from_config, the ladder,
# exact, extenders, node truncation, warmup)
# ---------------------------------------------------------------------------

#: the v1alpha1 document header every arm's configuration carries
GV = {"apiVersion": "kubescheduler.config.k8s.io/v1alpha1",
      "kind": "KubeSchedulerConfiguration"}


def configured(doc: dict, tmp: str, name: str, **kw):
    """Write ``doc`` as a JSON KubeSchedulerConfiguration, load it with
    ``cli.load_config_file`` (as ``python -m kubernetes_tpu_torch
    --config`` does) and build ``Scheduler.from_config`` on the card."""
    from kubernetes_tpu_torch.cli import load_config_file
    from kubernetes_tpu_torch.scheduler import Scheduler

    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w") as f:
        json.dump({**GV, **doc}, f)
    return Scheduler.from_config(load_config_file(path), **kw)


def _solve_spans(trace) -> dict:
    return {k: v for k, v in trace.span_durations().items()
            if k.startswith(("solve:", "pipeline:dispatch",
                             "pipeline:readback"))}


class HostTimer:
    """Host seconds spent in the given methods (``(object, name)`` pairs,
    each wrapped in place), on ``perf_counter``, summed since the last
    ``take()``."""

    def __init__(self, targets) -> None:
        self.total = 0.0
        for obj, name in targets:
            setattr(obj, name, self._timed(getattr(obj, name)))

    def _timed(self, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.total += time.perf_counter() - t0
        return run

    def take(self) -> float:
        got, self.total = self.total, 0.0
        return got


def SolveTimer(sched) -> HostTimer:
    """Host seconds a scheduler spends solving: its tier runs (the
    dispatch), its validated readbacks and its sparse frames. The cycle's
    spans read the scheduler's clock, which a simulated hub holds still
    inside a cycle, so they give 0 there."""
    return HostTimer((sched, name) for name in (
        "_run_tier", "_validated_readback", "_solve_frame"))


def config_arm_a(tmp: str) -> dict:
    """Arm A: cell ``pipeline-5k-30k`` through ``Scheduler.from_config``
    with ``solver: batch`` and ``solver: sinkhorn``, ``warmup: {enabled:
    true}`` and ``percentageOfNodesToScore: 100`` (the v1alpha1 default,
    0, is the reference's adaptive rule: 10% of 5000 nodes, which takes
    the cycle off the pipelined executor). After the node sync the
    scheduler warms with the first 64 pending pods, as ``cli.run``'s gate
    does. Fails unless warmup captured graphs and no cycle captured one,
    every pod binds on the configured tier with no fallback, capacity is
    clean, and the placements equal a hand-built ``Scheduler`` with the
    same arguments (unwarmed)."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.config import (
        RobustnessConfig,
        default_predicate_mask,
        default_priority_weights,
    )
    from kubernetes_tpu_torch.ops import device_loop
    from kubernetes_tpu_torch.scheduler import Scheduler

    out = {}
    launches = {}
    for solver in ("batch", "sinkhorn"):
        nodes, bound, pending = pipeline_cell()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        sched = configured({"solver": solver,
                            "percentageOfNodesToScore": 100,
                            "warmup": {"enabled": True}}, tmp,
                           f"arm-a-{solver}")
        feed(sched, nodes, bound, pending)
        c0 = device_loop.CAPTURES.count
        t0 = time.perf_counter()
        # cli.run's gate: the first 64 active pods after the node sync
        warmed = sched.warmup(
            sample_pods=sched.queue.pending_pods()["active"][:64])
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        warm_captures = device_loop.CAPTURES.count - c0
        mem_after_warmup = torch.cuda.memory_allocated()
        peak_after_warmup = torch.cuda.max_memory_allocated()
        results = []
        for _ in range(16):
            t0 = time.perf_counter()
            r = sched.schedule_cycle()
            torch.cuda.synchronize()
            if r.attempted == 0:
                break
            results.append((r, time.perf_counter() - t0,
                            _solve_spans(sched.obs.last_trace)))
        got = launch_counts()
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        rs = [r for r, _, _ in results]
        scheduled = sum(r.scheduled for r in rs)
        captures_after = sum(r.graph_captures for r in rs)
        if warmed <= 0 or warm_captures <= 0:
            fail(f"config/A/{solver}: warmup warmed {warmed} shapes, "
                 f"captured {warm_captures} graphs")
        if captures_after:
            fail(f"config/A/{solver}: {captures_after} round-loop graphs "
                 "captured after warmup")
        if scheduled != len(pending):
            fail(f"config/A/{solver}: bound {scheduled} of {len(pending)}")
        for r in rs:
            if r.solver_tier != solver or r.solver_fallbacks:
                fail(f"config/A/{solver}: a cycle solved on tier "
                     f"{r.solver_tier!r} after {r.solver_fallbacks} "
                     "fallbacks")
        placed = {}
        for r in rs:
            placed.update(r.assignments)
        recheck_capacity(nodes, bound, placed, {p.key(): p for p in pending})
        pinned = device_loop.pinned_count()
        del sched
        release_graphs()
        # the same arguments by hand, no warmup
        hand = Scheduler(solver=solver, pred_mask=default_predicate_mask(),
                         weights=default_priority_weights(),
                         robustness=RobustnessConfig())
        feed(hand, *pipeline_cell())
        want = {}
        for _ in range(16):
            r = hand.schedule_cycle()
            if r.attempted == 0:
                break
            want.update(r.assignments)
        if want != placed:
            n = sum(placed.get(k) != v for k, v in want.items())
            fail(f"config/A/{solver}: placements differ from the "
                 f"hand-built Scheduler on {n} pods")
        del hand
        release_graphs()
        cycle_s = [w for _, w, _ in results]
        out[solver] = {
            "warmed_shapes": warmed, "warmup_s": warm_s,
            "graph_captures_warmup": warm_captures,
            "graphs_pinned": pinned,
            "graph_captures_after_warmup": captures_after,
            "memory_allocated_after_warmup_gib": mem_after_warmup / 2**30,
            "max_memory_allocated_after_warmup_gib":
                peak_after_warmup / 2**30,
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2**30,
            "attempted": [r.attempted for r in rs],
            "pipeline_chunks": [r.pipeline_chunks for r in rs],
            "rounds": [r.rounds for r in rs],
            "host_syncs": [r.host_syncs for r in rs],
            "cycle_s": cycle_s, "solve_s": [r.solve_s for r in rs],
            "solve_spans_s": [sp for _, _, sp in results],
            "pods_per_s": scheduled / sum(cycle_s),
            "scheduled": scheduled, "tier": solver,
            "placements_equal_hand_built": True, "launches": got}
    return {"arms": out, "launches": launches, "cycles": sum(
        len(v["attempted"]) for v in out.values())}


class _KernelFaultOnRetry:
    """A fault injector whose first ``solve:batch`` attempt crashes (a
    solver fault, so the ladder retries) and whose retry hits a broken
    kernel (``KernelError``, which must reach the caller)."""

    def __init__(self):
        from kubernetes_tpu_torch import faults, kernels

        self.calls = 0
        self.crash = faults.SolverCrash
        self.kernel_error = kernels.KernelError

    def solver_hook(self, site, assigned, usage, rounds, n_nodes):
        self.calls += 1
        if self.calls == 1:
            raise self.crash(f"injected crash at {site}")
        raise self.kernel_error(f"injected kernel fault at {site}")

    def device_hook(self, site):
        return None


class _Clock:
    """A hand-advanced clock (the breaker's open duration)."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _ladder_cycle(sched, pods):
    for p in pods:
        sched.on_pod_add(p)
    t0 = time.perf_counter()
    r = sched.schedule_cycle()
    return r, time.perf_counter() - t0


#: arm B's batch: each of its ten fault kinds ends in one ``batch-cpu``
#: solve of this many pods against the 8192-column table on the host's
#: CPU (at 4096 pods each took 5-10 s; cut to keep the script under half
#: its time limit, every kind and every check kept)
CONFIG_B_PODS = 1024


def config_arm_b(tmp: str) -> dict:
    """Arm B: the ladder on the smoke cluster (5000 nodes, 1000 bound)
    with ``CONFIG_B_PODS`` pending pods, one monolithic cycle. A
    ``FaultInjector`` fails ``solve:batch`` with each raising kind and
    each poisoning kind in turn: the retry runs, then ``batch-cpu`` places
    the batch, equal to
    the same cycle without a fault. Then, on 64-pod cycles: the breaker
    opens after ``breakerFailureThreshold`` cycles, sheds the tier, and
    half-opens after ``breakerOpenDuration`` on a hand-advanced clock; a
    blown ``cycleDeadline`` skips to ``greedy``; a ``KernelError`` on the
    retry reaches the caller."""
    import torch

    from kubernetes_tpu_torch import faults, kernels
    from kubernetes_tpu_torch.testing import make_pod

    nodes, bound, pending = smoke_cell(n_pending=CONFIG_B_PODS)
    doc = {"solver": "batch", "percentageOfNodesToScore": 100}
    base = configured(doc, tmp, "arm-b")
    feed(base, nodes, bound, pending)
    r0, s0 = _ladder_cycle(base, [])
    if r0.solver_tier != "batch" or r0.scheduled != len(pending):
        fail(f"config/B: the fault-free cycle solved on {r0.solver_tier!r}, "
             f"bound {r0.scheduled}")
    del base
    kinds = {}
    for kind in ("timeout", "connection", "crash", "device_lost",
                 "device_oom", "partial", "stale", "garbage", "nan",
                 "infeasible"):
        inj = faults.FaultInjector(seed=7).arm("solve:batch", kind)
        sched = configured(doc, tmp, "arm-b", fault_injector=inj,
                           retry_sleep=lambda _s: None)
        feed(sched, nodes, bound, pending)
        r, wall = _ladder_cycle(sched, [])
        if r.tier_attempts != ["batch", "batch", "batch-cpu"]:
            fail(f"config/B/{kind}: tiers {r.tier_attempts}")
        if r.assignments != r0.assignments:
            fail(f"config/B/{kind}: batch-cpu placed differently from the "
                 "fault-free cycle")
        kinds[kind] = {"tiers": r.tier_attempts, "scheduled": r.scheduled,
                       "cycle_s": wall,
                       "batch_cpu_s": sched.obs.last_trace.span_durations()
                       .get("solve:batch-cpu"),
                       "rejections": dict(
                           (k[1], v) for k, v in
                           sched.metrics.solver_rejections._values.items()),
                       "host_syncs": r.host_syncs}
        del sched
        torch.cuda.empty_cache()

    # the breaker: threshold 2, open 30 s, 64-pod cycles on a fake clock
    clock = _Clock()
    inj = faults.FaultInjector(seed=9).arm("solve:batch", "crash")
    sched = configured({**doc, "robustness": {
        "breakerFailureThreshold": 2, "breakerOpenDuration": "30s"}},
        tmp, "arm-b-breaker", fault_injector=inj, clock=clock,
        retry_sleep=lambda _s: None)
    feed(sched, nodes, bound, [])
    extra = [make_pod(f"extra-{i}", cpu_milli=100, memory=500 * 2**20)
             for i in range(4 * 64)]
    breaker = []
    for k in range(4):
        if k == 3:
            clock.t += 31.0
            inj.rules.clear()
        r, wall = _ladder_cycle(sched, extra[64 * k: 64 * (k + 1)])
        breaker.append({"tiers": r.tier_attempts, "tier": r.solver_tier,
                        "scheduled": r.scheduled, "cycle_s": wall,
                        "state": sched._breakers["solver:batch"].state})
    want = [["batch", "batch", "batch-cpu"], ["batch", "batch", "batch-cpu"],
            ["batch:shed", "batch-cpu"], ["batch"]]
    if [b["tiers"] for b in breaker] != want or [
            b["state"] for b in breaker] != ["closed", "open", "open",
                                             "closed"]:
        fail(f"config/B/breaker: {breaker}")
    breaker_metrics = {
        "breaker_state": {k[0]: v for k, v in
                          sched.metrics.breaker_state._values.items()},
        "solver_fallbacks": {f"{k[0]}->{k[1]}": v for k, v in
                             sched.metrics.solver_fallbacks._values.items()},
        "solver_retries": {k[0]: v for k, v in
                           sched.metrics.solver_retries._values.items()}}
    del sched

    # a blown deadline: 1 ms is gone before the ladder starts
    sched = configured({**doc, "robustness": {"cycleDeadline": "1ms"}},
                       tmp, "arm-b-deadline")
    feed(sched, nodes, bound, [])
    r, wall = _ladder_cycle(sched, extra[:64])
    if r.tier_attempts != ["batch:shed", "greedy"] or r.scheduled != 64 \
            or sched.metrics.deadline_exceeded.value() != 1:
        fail(f"config/B/deadline: tiers {r.tier_attempts}, bound "
             f"{r.scheduled}")
    deadline = {"tiers": r.tier_attempts, "scheduled": r.scheduled,
                "cycle_s": wall}
    del sched

    # a kernel fault on the retry reaches the caller
    sched = configured(doc, tmp, "arm-b-kernel",
                       fault_injector=_KernelFaultOnRetry(),
                       retry_sleep=lambda _s: None)
    feed(sched, nodes, bound, extra[:64])
    try:
        sched.schedule_cycle()
        fail("config/B/kernel: the KernelError did not reach the caller")
    except kernels.KernelError as e:
        kernel_fault = str(e)
    del sched
    release_graphs()
    return {"fault_free_cycle_s": s0, "kinds": kinds, "breaker": breaker,
            "breaker_metrics": breaker_metrics, "deadline": deadline,
            "kernel_error_reached_caller": kernel_fault}


def config_arm_c(tmp: str) -> dict:
    """Arm C: ``solver: exact`` on 500 nodes with 512 pending pods (cut
    to size: the host Hungarian is O(n^3) numpy). The placements must
    equal the plain ``native.exact_assign`` on the same host matrices
    (each call's inputs recorded, recomputed) and the same cycle on CPU
    tensors; capacity clean; a batch with topology terms goes to
    ``batch``."""
    from kubernetes_tpu_torch import native
    from kubernetes_tpu_torch.api.types import (
        Affinity,
        LabelSelector,
        PodAffinityTerm,
    )
    from kubernetes_tpu_torch.testing import make_pod

    nodes, bound, pending = smoke_cell(500, 100, 512, seed=3)
    doc = {"solver": "exact", "percentageOfNodesToScore": 100}
    calls = []
    real = native.exact_assign

    def recording(score, mask, cap):
        out = real(score, mask, cap)
        calls.append((score.copy(), mask.copy(), cap.copy(), out.copy()))
        return out

    native.exact_assign = recording
    try:
        sched = configured(doc, tmp, "arm-c")
        feed(sched, nodes, bound, pending)
        r, wall = _ladder_cycle(sched, [])
    finally:
        native.exact_assign = real
    if r.solver_tier != "exact" or r.solver_fallbacks or not calls:
        fail(f"config/C: tier {r.solver_tier!r}, {len(calls)} exact calls")
    for score, mask, cap, got in calls:
        if not (real(score, mask, cap) == got).all():
            fail("config/C: exact_assign disagrees with its recomputation")
    cpu = configured(doc, tmp, "arm-c", device="cpu")
    feed(cpu, nodes, bound, pending)
    rc, _ = _ladder_cycle(cpu, [])
    if rc.assignments != r.assignments:
        fail("config/C: the exact tier placed differently on CPU tensors")
    recheck_capacity(nodes, bound, r.assignments,
                     {p.key(): p for p in pending})
    anti = Affinity(pod_anti_affinity_required=(PodAffinityTerm(
        label_selector=LabelSelector(match_labels={"app": "spread"}),
        topology_key=HOSTNAME),))
    topo = [make_pod(f"anti-{i}", cpu_milli=100, labels={"app": "spread"},
                     affinity=anti) for i in range(32)]
    rt, _ = _ladder_cycle(sched, topo)
    if rt.solver_tier != "batch" or sched.exact_fallbacks != 1 \
            or rt.scheduled != 32 or len(set(rt.assignments.values())) != 32:
        fail(f"config/C: the topology batch solved on {rt.solver_tier!r}, "
             f"{sched.exact_fallbacks} routings, {rt.scheduled} bound")
    return {"nodes": len(nodes), "pending": len(pending),
            "scheduled": r.scheduled,
            "cycle_s": wall, "solve_s": r.solve_s, "rounds": r.rounds,
            "exact_calls": len(calls),
            "slot_columns": [int(c[2].sum()) for c in calls],
            "cpu_equal": True, "topology_batch_tier": rt.solver_tier}


class _ExtenderHandler:
    """The extender endpoint served on 127.0.0.1 (node-cache-capable wire
    form): filter drops every node whose index is a multiple of 3,
    prioritize scores a node by its index modulo 5."""

    @staticmethod
    def make():
        import http.server

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = json.loads(self.rfile.read(
                    int(self.headers["Content-Length"])))
                names = body.get("nodenames") or []
                idx = {n: int(n.rsplit("-", 1)[1]) for n in names}
                if self.path.endswith("/filter"):
                    resp = {"nodenames": [n for n in names if idx[n] % 3]}
                else:
                    resp = [{"host": n, "score": idx[n] % 5} for n in names]
                data = json.dumps(resp).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        return Handler


def config_arm_d(tmp: str) -> dict:
    """Arm D, 5000 nodes: 256 pending pods through one extender (filter +
    prioritize, weight 1) that this phase serves itself on 127.0.0.1
    (``http.server`` in a thread; one pod a call, as the protocol is);
    then ``percentageOfNodesToScore: 50`` on 256 more. Fails unless every
    bound node passed the extender's filter, and every pod bound under
    truncation landed in its cycle's ``NodeTree.take(k)`` subset."""
    import http.server
    import threading

    from kubernetes_tpu_torch.nodetree import num_feasible_nodes_to_find

    nodes, bound, pending = smoke_cell(n_pending=512, seed=5)
    # the extender lives on loopback: no proxy may stand in between
    saved = {k: os.environ.pop(k) for k in list(os.environ)
             if k.lower() in ("http_proxy", "https_proxy", "all_proxy")}
    os.environ["no_proxy"] = os.environ["NO_PROXY"] = "127.0.0.1,localhost"
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                          _ExtenderHandler.make())
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/ext"
        sched = configured({
            "percentageOfNodesToScore": 100,
            "algorithmSource": {"policy": {"kind": "Policy", "extenders": [
                {"urlPrefix": url, "filterVerb": "filter",
                 "prioritizeVerb": "prioritize", "weight": 1,
                 "nodeCacheCapable": True}]}}}, tmp, "arm-d-extender")
        half = len(pending) // 2
        feed(sched, nodes, bound, pending[:half])
        r, wall = _ladder_cycle(sched, [])
        ext_span = sched.obs.last_trace.span_durations().get("extenders")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        os.environ.update(saved)
    if r.scheduled != half or r.solver_tier != "batch":
        fail(f"config/D: bound {r.scheduled} of {half} through the "
             f"extender on {r.solver_tier!r}")
    bad = [n for n in r.assignments.values()
           if int(n.rsplit("-", 1)[1]) % 3 == 0]
    if bad:
        fail(f"config/D: {len(bad)} pods bound on nodes the extender "
             "filtered out")
    trunc = configured({"percentageOfNodesToScore": 50}, tmp,
                       "arm-d-truncated")
    subsets = []
    real_take = trunc.node_tree.take

    def take(n):
        got = real_take(n)
        subsets.append(set(got))
        return got

    trunc.node_tree.take = take
    feed(trunc, nodes, bound, pending[half:])
    rt, wall_t = _ladder_cycle(trunc, [])
    k = num_feasible_nodes_to_find(len(nodes), 50)
    if rt.scheduled != len(pending) - half or len(subsets) != 1 \
            or len(subsets[0]) != k:
        fail(f"config/D: truncation bound {rt.scheduled}, subsets "
             f"{[len(s) for s in subsets]}")
    outside = [n for n in rt.assignments.values() if n not in subsets[0]]
    if outside or rt.pipeline_chunks:
        fail(f"config/D: {len(outside)} pods bound outside the subset")
    release_graphs()
    return {"extender": {"scheduled": r.scheduled, "cycle_s": wall,
                         "extenders_span_s": ext_span,
                         "host_syncs": r.host_syncs},
            "truncation": {"scheduled": rt.scheduled, "k": k,
                           "cycle_s": wall_t,
                           "nodes_used": len(set(rt.assignments.values()))}}


def phase_config() -> dict:
    """The configured scheduler: arms A-D (see each). Every arm's
    configuration is a JSON v1alpha1 document this phase writes to a
    temporary directory and loads with ``load_config_file``; the
    scheduler is built with ``Scheduler.from_config``. Returns arm A's
    kernel launches (the configured main path, counted from 0 before its
    first scheduler is built, warmup included)."""
    import tempfile

    import torch

    # warm the libraries and this path off the clock
    run_pipeline(2, pipeline_cell(100, 20, 600, seed=1), chunk=256)
    release_graphs()
    with tempfile.TemporaryDirectory(prefix="ktt-config-") as tmp:
        main = config_arm_a(tmp)
        emit({"phase": "config", "arm": "A", "cell": "pipeline-5k-30k",
              **main["arms"]})
        b = config_arm_b(tmp)
        emit({"phase": "config", "arm": "B", "cell": "ladder-5k-4096", **b})
        c = config_arm_c(tmp)
        emit({"phase": "config", "arm": "C", "cell": "exact-500-512", **c})
        d = config_arm_d(tmp)
        emit({"phase": "config", "arm": "D", "cell": "extender-5k-256", **d})
    torch.cuda.empty_cache()
    return {"launches": main["launches"], "cycles": main["cycles"]}


# ---------------------------------------------------------------------------
# phase 12: the serve loop (cli.run, ServingRuntime, leader election with
# fenced binds and takeover reconciliation, the extender server)
# ---------------------------------------------------------------------------

#: ops/s (creates + deletes) the serve arms offer: bench_churn's default
#: non-mesh rate, in 10 Hz bursts
SERVE_RATE = 500.0
#: the micro-batch window's latency ceiling (bench_churn's non-mesh
#: default; ServingConfig's is 50 ms)
SERVE_MAX_WAIT = "20ms"
#: arm C's offered rate, a multiple of SERVE_RATE above what the serve
#: loop binds at 5000 nodes (so it must shed)
OVERLOAD_FACTOR = 40
#: the undelivered events the overload's informer buffer holds (arm C):
#: a producer that fills it waits for the next delivery
INFORMER_BUFFER = 4096
#: the lease cut for arm D, so a takeover fits the run (the defaults are
#: 15 s / 10 s / 2 s)
SERVE_LEASE = {"leaseDuration": "2s", "renewDeadline": "1500ms",
               "retryPeriod": "500ms"}


def serve_pod(name: str, i: int, rng, node_name: str = "",
              cpu_milli: int = 100):
    """One pod of the smoke cell's shape: 100m (``cpu_milli``) / 500 Mi,
    preferring one seeded zone at weight 50, the odd ones tolerating the
    PreferNoSchedule taint."""
    from kubernetes_tpu_torch.api.types import Toleration
    from kubernetes_tpu_torch.testing import (
        make_pod,
        node_affinity_preferred,
        req,
    )

    tol = (Toleration(key=SOFT_TAINT, operator="Exists",
                      effect="PreferNoSchedule"),)
    return make_pod(
        name, cpu_milli=cpu_milli, memory=500 * 2**20, node_name=node_name,
        affinity=node_affinity_preferred(
            (50, [req(ZONE, "In", f"zone-{rng.randrange(10)}")])),
        tolerations=tol if i % 2 else ())


class Churn:
    """bench_churn's ChurnProducer for the port: creates and deletes in
    10 Hz bursts at ``rate`` ops/s (half each; a delete retires a bound
    pod, so the node table churns). Each burst reaches the scheduler as
    one informer delivery through ``ingest`` (the serving loop's lock).
    A create is stamped with its creation time on the scheduler's clock
    (``queued_at``), so ``CycleResult.e2e_latency_s`` is create-to-bind.
    ``admit`` (arm C) takes an APF seat on the mutating flow for each
    create and counts the sheds. ``flood`` (arm C, bench_churn's overload
    arm) offers pods made before the clock starts, in 100 Hz bursts, and
    hands admitted creates and deletes to a pump thread that delivers
    them every 2 ms (an informer whose buffer holds INFORMER_BUFFER
    undelivered events; a full buffer makes the producer wait), so a
    cycle holding the ingest lock does not stop admission, and the
    producer spends little of the interpreter lock the loop needs."""

    def __init__(self, ingest, sched, prefix: str, seed: int,
                 rate: float = SERVE_RATE, duration: float = 30.0,
                 admit=None, flood: bool = False) -> None:
        import collections
        import random

        self.ingest, self.sched = ingest, sched
        self.prefix, self.rng = prefix, random.Random(seed)
        self.rate, self.duration = rate, duration
        self.admit, self.flood = admit, flood
        self.pods: dict = {}  # key -> Pod, every create admitted
        self.deleted: set = set()
        self.shed = 0
        self.offered = 0
        self.results: list = []  # (host stamp, CycleResult)
        self.backlog: list = []  # (key, node) bound, not yet deleted
        self._seen = 0
        self._inbox = collections.deque()
        self.max_queue_depth = 0
        self.max_undelivered = 0  # the flood's informer buffer, at most
        self.error = None
        self._pool = collections.deque(
            serve_pod(f"{prefix}-{n}", n, self.rng)
            for n in range(int(rate / 2 * duration) + 1)) if flood else None

    def on_cycle(self, res) -> None:
        self.results.append((time.perf_counter(), res))

    def _apply(self, events) -> None:
        for add, pod in events:
            if add:
                self.sched.on_pod_add(pod)
            else:
                self.sched.on_pod_delete(pod)

    def _deliver(self, events) -> None:
        if events:
            self.ingest(self._apply, events)
        self.max_queue_depth = max(self.max_queue_depth,
                                   len(self.sched.queue))

    def _create(self, out) -> None:
        from kubernetes_tpu_torch.serving import RequestRejected

        n = self.offered
        self.offered += 1
        pod = (self._pool.popleft() if self._pool
               else serve_pod(f"{self.prefix}-{n}", n, self.rng))
        if self.admit is not None:
            try:
                self.admit()
            except RequestRejected:
                self.shed += 1
                return
        pod.queued_at = time.monotonic()
        self.pods[pod.key()] = pod
        out.append((True, pod))

    def _delete(self, n: int, out) -> None:
        import dataclasses

        while self._seen < len(self.results):
            self.backlog.extend(
                (k, v) for k, v in self.results[self._seen][1]
                .assignments.items() if k in self.pods)
            self._seen += 1
        for _ in range(max(n, 0)):
            if not self.backlog:
                return
            key, node = self.backlog.pop(0)
            self.deleted.add(key)
            out.append((False, dataclasses.replace(self.pods[key],
                                                   node_name=node)))

    def run(self) -> None:
        try:
            if self.flood:
                self._run_flood()
            else:
                self._run_paced()
        except BaseException as e:  # reported by the arm, never dropped
            self.error = e

    def _run_paced(self) -> None:
        start = time.monotonic()
        issued, next_burst = 0, start
        while time.monotonic() - start < self.duration:
            now = time.monotonic()
            if now < next_burst:
                time.sleep(next_burst - now)
            next_burst += 0.1
            target = self.rate * (min(time.monotonic(),
                                      start + self.duration) - start)
            ops = int(target) - issued
            issued += ops
            events: list = []
            for _ in range(ops // 2 + ops % 2):
                self._create(events)
            self._delete(ops // 2, events)
            self._deliver(events)

    def _run_flood(self) -> None:
        import threading

        done = threading.Event()

        def pump():
            try:
                while not done.is_set() or self._inbox:
                    batch = []
                    while self._inbox:
                        batch.append(self._inbox.popleft())
                    self._deliver(batch)
                    time.sleep(0.002)
            except BaseException as e:  # reported by the arm
                self.error = e

        t = threading.Thread(target=pump, name=f"pump-{self.prefix}",
                             daemon=True)
        t.start()
        start = time.monotonic()
        issued, next_burst = 0, start
        try:
            while time.monotonic() - start < self.duration:
                now = time.monotonic()
                if now < next_burst or len(self._inbox) >= INFORMER_BUFFER:
                    time.sleep(max(next_burst - now, 0.0005))
                    continue
                next_burst += 0.01
                target = self.rate * (min(time.monotonic(),
                                          start + self.duration) - start)
                # what does not fit the buffer waits for the next burst
                ops = min(int(target) - issued,
                          INFORMER_BUFFER - len(self._inbox))
                issued += ops
                events: list = []
                for _ in range(ops // 2 + ops % 2):
                    self._create(events)
                self._delete(ops // 2, events)
                self._inbox.extend(events)
                self.max_undelivered = max(self.max_undelivered,
                                           len(self._inbox))
        finally:
            done.set()
            t.join(timeout=60)


def _pct(vals, q):
    import numpy as np

    return float(np.percentile(np.asarray(vals), q)) if vals else None


def _wait_for(cond, limit_s: float, what: str) -> None:
    deadline = time.monotonic() + limit_s
    while not cond():
        if time.monotonic() > deadline:
            fail(f"serve: timed out after {limit_s} s waiting for {what}")
        time.sleep(0.02)


def _bound_once(arm: str, pods: dict, results) -> dict:
    """Every admitted pod bound exactly once; returns key -> node."""
    placed: dict = {}
    for _, r in results:
        for k, node in r.assignments.items():
            if k in placed:
                fail(f"serve/{arm}: {k} bound twice")
            placed[k] = node
    missing = [k for k in pods if k not in placed]
    if missing:
        fail(f"serve/{arm}: {len(missing)} of {len(pods)} created pods never "
             f"bound (first {missing[:3]})")
    return placed


def _live_capacity(arm, nodes, bound, churns) -> None:
    """The host capacity re-check over the pods still placed."""
    live: dict = {}
    by_key: dict = {}
    for ch in churns:
        for _, r in ch.results:
            for k, node in r.assignments.items():
                if k in ch.pods and k not in ch.deleted:
                    live[k] = node
        by_key.update(ch.pods)
    recheck_capacity(nodes, bound, live, by_key)


def _serve_cycles(results) -> dict:
    """The per-cycle summary a serve arm reports."""
    rs = [r for _, r in results if r.attempted]
    lats = [v for r in rs for v in r.e2e_latency_s.values()]
    sizes = [r.attempted for r in rs]
    flushes: dict = {}
    for r in rs:
        flushes[r.flush_trigger or "none"] = flushes.get(
            r.flush_trigger or "none", 0) + 1
    return {"cycles": len(rs), "bound": sum(r.scheduled for r in rs),
            "p50_s": _pct(lats, 50), "p99_s": _pct(lats, 99),
            "max_s": max(lats) if lats else None,
            "flush_triggers": flushes,
            "batch_sizes": {"min": min(sizes, default=0),
                            "p50": _pct(sizes, 50),
                            "max": max(sizes, default=0)},
            "host_syncs_per_cycle": (sum(r.host_syncs for r in rs)
                                     / max(len(rs), 1)),
            "graph_captures": sum(r.graph_captures for r in rs),
            "cycle_s_p50": _pct([r.elapsed_s for r in rs], 50),
            "solve_s_p50": _pct([r.solve_s for r in rs], 50),
            "tiers": sorted({r.solver_tier for r in rs})}


def _run_cli(cfg, argv, on_ready):
    """``cli.run(cfg, args, stop)`` on a thread; returns (stop, thread,
    box) with the handles ``on_ready`` received and any exception the
    run raised in ``box``."""
    import threading

    from kubernetes_tpu_torch import cli

    args = cli.build_parser().parse_args(["--port", "0", *argv])
    stop = threading.Event()
    box: dict = {}
    ready = threading.Event()

    def hook(ctx):
        box.update(ctx)
        on_ready(ctx)
        ready.set()

    def target():
        try:
            cli.run(cfg, args, stop, on_ready=hook)
        except BaseException as e:  # re-raised by the arm, never dropped
            box["error"] = e
            ready.set()

    t = threading.Thread(target=target, name="cli.run", daemon=True)
    t.start()
    _wait_for(ready.is_set, 300, "cli.run to start")
    if "error" in box:
        raise box["error"]
    return stop, t, box


def _stop_cli(stop, t, box, arm: str) -> None:
    stop.set()
    t.join(timeout=60)
    if t.is_alive():
        fail(f"serve/{arm}: cli.run did not stop")
    if "error" in box:
        raise box["error"]


class ConfirmingBinder:
    """Binds and has the bound pod's MODIFIED event delivered as soon as
    the cycle that bound it returns, as a cluster whose watch answers at
    once (the simulated cluster's default) and whose informer delivers
    between cycles: the cache's assumption becomes a binding, so no
    assumption outlives its TTL and requeues a pod that is bound, and the
    bind's own success tail (the journey's close) runs before the event,
    as it does against a real informer. With ``truth`` (arm D) the bind
    first goes through the shared CAS."""

    def __init__(self, sched, truth=None) -> None:
        self.sched, self.truth = sched, truth
        self.confirmed: list = []
        real = sched.schedule_cycle

        def cycle(*a, **kw):
            r = real(*a, **kw)
            self.deliver()
            return r

        sched.schedule_cycle = cycle

    def bind(self, pod, node_name: str) -> None:
        if self.truth is not None:
            self.truth.bind(pod, node_name)
        self.confirmed.append((pod, node_name))

    def deliver(self) -> None:
        import dataclasses

        done, self.confirmed = self.confirmed, []
        for pod, node_name in done:
            self.sched.on_pod_update(pod, dataclasses.replace(
                pod, node_name=node_name))


class CycleHooks:
    """Wraps a scheduler's ``schedule_cycle`` for the serve arms: one
    flagged cycle runs under ``torch.cuda.set_sync_debug_mode("error")``
    (any sync that does not go through the counted ``to_host`` raises,
    or sends the ladder to a fallback tier, which the arm fails), one
    under torch.profiler (the device's idle share)."""

    def __init__(self, sched) -> None:
        import threading

        self.debug = threading.Event()
        self.profile = threading.Event()
        self.debug_result = None
        self.profile_out = None
        real = sched.schedule_cycle

        def cycle(*a, **kw):
            import torch
            from torch.profiler import ProfilerActivity, profile

            if self.debug.is_set() and len(sched.queue):
                self.debug.clear()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    r = real(*a, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                self.debug_result = r
                return r
            if self.profile.is_set() and len(sched.queue):
                self.profile.clear()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    r = real(*a, **kw)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                self.profile_out = {"attempted": r.attempted,
                                    "wall_s": wall, **busy_share(prof, wall)}
                return r
            return real(*a, **kw)

        sched.schedule_cycle = cycle


def _serve_config(tmp: str, name: str, **doc):
    from kubernetes_tpu_torch.cli import load_config_file

    base = {"percentageOfNodesToScore": 100,
            "warmup": {"enabled": True, "minBucket": 8},
            "serving": {"enabled": True, "maxWait": SERVE_MAX_WAIT},
            "leaderElection": {"leaderElect": True}}
    base.update(doc)
    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w") as f:
        json.dump({**GV, **base}, f)
    return path, load_config_file(path)


def serve_soak(sched, rt):
    """A ``SoakEngine`` attached to the serving scheduler (so
    ``/debug/soak`` serves it): the leak sentinels over the scheduler,
    its registry and ``scheduler_pending_pods``' freshness, sampled
    under the serving loop's ingest lock; the standard counters, the
    clean-zero ones those a serve arm must not move."""
    from kubernetes_tpu_torch.soak import (
        SoakEngine,
        SoakSentinels,
        standard_counters,
    )

    sent = SoakSentinels(sched=sched, registry=sched.metrics.registry,
                         fresh_gauges=["scheduler_pending_pods"])
    sample = sent.sample
    sent.sample = lambda *a, **k: rt.loop.ingest(sample, *a, **k)
    return SoakEngine([], sent, counters=standard_counters(sched),
                      clean_zero=("retraces", "fenced_binds",
                                  "journey_drops"),
                      clock=time.monotonic, sleep=time.sleep, step_s=1.0,
                      sample_every_s=5.0).attach(sched)


def serve_soak_verdict(engine, sched) -> dict:
    """The sentinels' growth verdict over the arm's clean phases; a leak
    or a failed phase fails the run. The churn adds live pods by design
    (creates outnumber deletes), so the series keyed by live pods may grow
    up to the live pod count, never past it. The process's resident set
    is printed and not judged: the arm lasts seconds, in which the
    allocators' pools still grow (the reference's 64 MB row is for
    windows of hours)."""
    live = sched.cache.pod_count()
    tol = engine.sentinels.tolerance
    for key in ("sched.cache_pods", "sched.packer_pod_refs",
                "sched.packer_vec_cache"):
        tol[key] = float(live)
    tol["rss_kb"] = float("inf")
    growth = engine.sentinels.growth_report()
    leaking = sorted(k for k, v in growth.items() if v["growing"])
    bad = [r for r in engine.reports if not r["ok"]]
    if leaking or bad:
        fail(f"serve/A: soak sentinels leaking "
             f"{ {k: growth[k] for k in leaking} } with {live} live pods, "
             f"phases failed "
             f"{[(r['name'], r['violations']) for r in bad]}")
    return {"phases": [(r["name"], r["kind"], r["ok"])
                       for r in engine.reports],
            "clean_samples": sum(1 for r in engine.sentinels.samples
                                 if r["clean"]),
            "live_pods": live, "leaking": leaking,
            "rss_kb": [r["values"]["rss_kb"] for r in engine.sentinels.samples
                       if r["clean"]],
            "grew": {k: v["growth"] for k, v in growth.items()
                     if v["growth"] > 0}}


def journey_spy(sched) -> list:
    """(pod key, create-to-bind seconds) of every journey the tracker
    closes bound, as it closes (the tracker keeps only its slowest and
    sampled journeys)."""
    jt = sched.obs.journeys
    rows: list = []
    retain = jt._retain

    def spy(j, now):
        rows.append((j.key, j.e2e_s))
        retain(j, now)

    jt._retain = spy
    return rows


def serve_debug_routes(srv, sched) -> dict:
    """GET the serving scheduler's debug routes: ``/debug/flightrecorder``
    (its cycle records), ``/debug/journeys`` and one bound pod's timeline
    through ``?pod=``, ``/debug/soak`` (the attached engine) and
    ``/metrics`` (the unschedulable families' samples)."""
    import urllib.request

    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return r.status, r.read().decode()

    st, body = get("/debug/flightrecorder")
    fr = json.loads(body)["flight_recorder"]
    if st != 200 or not fr["records"] or any(
            "cycle" not in rec for rec in fr["records"]):
        fail(f"serve/A: /debug/flightrecorder answered {st} with "
             f"{len(fr['records'])} records")
    st, body = get("/debug/journeys")
    snap = json.loads(body)
    if st != 200 or not snap["slowest"]:
        fail(f"serve/A: /debug/journeys answered {st}: {body[:200]}")
    pod = snap["slowest"][0]["pod"]
    st, body = get(f"/debug/journeys?pod={pod}")
    tl = json.loads(body)
    if st != 200 or tl["outcome"] != "bound" or abs(
            sum(tl["phase_share"].values()) - 1.0) > 2e-3:
        fail(f"serve/A: the timeline of {pod}: {st} {body[:300]}")
    st, body = get("/debug/soak")
    soak = json.loads(body)
    if st != 200 or not soak["phases_done"]:
        fail(f"serve/A: /debug/soak answered {st}: {body[:200]}")
    st, body = get("/metrics")
    samples = [line for line in body.splitlines()
               if line.startswith(("scheduler_unschedulable_pods_total{",
                                   "scheduler_unschedulable_node_counts{"))]
    if st != 200 or len({line.split("{")[0] for line in samples}) != 2:
        fail(f"serve/A: /metrics has no unschedulable samples: {samples}")
    return {"flightrecorder_records": len(fr["records"]),
            "flightrecorder_recorded": fr["recorded"],
            "journeys": {k: snap[k] for k in ("created", "bound", "gone",
                                              "dropped", "pending")},
            "timeline": {"pod": pod, "e2e_s": tl["e2e_s"],
                         "phases_s": tl["phases_s"]},
            "soak_phases_done": [p["name"] for p in soak["phases_done"]],
            "unschedulable_samples": samples,
            "sinkhorn_samples": sched.metrics.sinkhorn_iterations.count()}


def serve_arm_ac(tmp: str, nodes, bound) -> dict:
    """Arms A (serving) and C (overload) on one ``cli.run``: the
    ServingRuntime behind an elector on an InMemoryLock, 30 s of churn
    at SERVE_RATE, then 10 s of creates flooded through the runtime's
    mutating APF flow."""
    import random
    import threading

    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.ops import device_loop
    from kubernetes_tpu_torch.soak import SoakPhase

    _path, cfg = _serve_config(tmp, "serve-a")
    hooks: dict = {}
    rng = random.Random(11)
    sample = [serve_pod(f"warm-{i}", i, rng) for i in range(64)]

    def on_ready(ctx):
        sched, rt = ctx["sched"], ctx["runtime"]
        sched.binder = ConfirmingBinder(sched)
        feed(sched, nodes, bound, sample)
        hooks["cycles"] = CycleHooks(sched)
        hooks["results"] = []
        rt.loop.on_cycle = lambda r: hooks["results"].append(
            (time.perf_counter(), r))

    stop, t, box = _run_cli(cfg, ["--device", "cuda"], on_ready)
    sched, rt, elector = box["sched"], box["runtime"], box["elector"]
    c0 = device_loop.CAPTURES.count
    # the gate acquires the lease (takeover reconciliation, which warms
    # with the 64 queued pods), then the first micro-batch binds them
    _wait_for(lambda: not rt._warmup_pending and elector.is_leader()
              and sched.cache.pod_count() >= len(bound) + len(sample),
              300, "the lease, the warmup and the first micro-batch")
    torch.cuda.synchronize()
    warm_captures = device_loop.CAPTURES.count - c0
    launches_warm = launch_counts()
    shapes_warm = launch_shapes()
    kernels.reset_launches()
    warm_results = list(hooks["results"])
    n_warm = len(warm_results)
    # the soak engine attached for the arm (/debug/soak): a clean phase
    # after the warmup, the churn as a traffic phase, clean phases at the
    # drained points after it; the leak sentinels sample under the loop's
    # ingest lock
    engine = serve_soak(sched, rt)
    engine.run_phase(SoakPhase("warm", 0.0, "clean"))
    journey_e2e = journey_spy(sched)
    # arm A: the churn, with one sync-debug and one profiled cycle
    prod = Churn(rt.loop.ingest, sched, "sv", seed=12, duration=30.0)
    rt.loop.on_cycle = lambda r: (hooks["results"].append(
        (time.perf_counter(), r)), prod.on_cycle(r))
    pt = threading.Thread(target=prod.run, name="churn-A", daemon=True)
    t0 = time.perf_counter()
    pt.start()
    debug_fired: list = []

    def tick(elapsed):
        if elapsed >= 10.0 and not debug_fired:
            debug_fired.append(elapsed)
            hooks["cycles"].debug.set()

    engine.run_phase(SoakPhase("serve-A", 30.0, "traffic", tick=tick))
    pt.join(timeout=90)
    if pt.is_alive() or prod.error:
        fail(f"serve/A: the producer failed: {prod.error!r}")
    _wait_for(lambda: len(sched.queue) == 0, 60, "arm A to drain")
    wall_a = time.perf_counter() - t0
    n_a_end = len(hooks["results"])
    engine.run_phase(SoakPhase("drained-A", 0.0, "clean"))
    # one pod of the churn's shape that no node can hold: the explain
    # path's families get samples (a pod of another shape would present a
    # solve the warmup did not cover)
    too_big = serve_pod("serve-too-big", 1, rng, cpu_milli=10**9)
    rt.loop.ingest(sched.on_pod_add, too_big)
    _wait_for(lambda: sched.metrics.unschedulable_pods.expose(), 30,
              "the unschedulable pod's cycle")
    rt.loop.ingest(sched.on_pod_delete, too_big)
    debug_routes = serve_debug_routes(box["server"], sched)
    # one burst more, its cycle under torch.profiler (outside the timed
    # churn: the profiler's start and stop hold the loop for seconds)
    hooks["cycles"].profile.set()
    extra = Churn(rt.loop.ingest, sched, "pf", seed=14)
    burst: list = []
    for _ in range(25):
        extra._create(burst)
    extra._deliver(burst)
    _wait_for(lambda: len(sched.queue) == 0
              and hooks["cycles"].profile_out is not None, 120,
              "the profiled cycle")
    engine.run_phase(SoakPhase("drained-profiled", 0.0, "clean"))
    soak = serve_soak_verdict(engine, sched)
    torch.cuda.synchronize()
    launches_a = launch_counts()
    shapes_a = launch_shapes()
    kernels.reset_launches()
    n_c_start = len(hooks["results"])
    # arm C: the same runtime, creates flooded through the mutating flow
    flow = rt.flow

    def admit():
        flow.release(flow.acquire("mutating"))

    over = Churn(rt.loop.ingest, sched, "ov", seed=13, duration=10.0,
                 rate=OVERLOAD_FACTOR * SERVE_RATE, admit=admit, flood=True)
    rt.loop.on_cycle = lambda r: (hooks["results"].append(
        (time.perf_counter(), r)), over.on_cycle(r))
    ct = threading.Thread(target=over.run, name="churn-C", daemon=True)
    t0 = time.perf_counter()
    ct.start()
    ct.join(timeout=60)
    if ct.is_alive() or over.error:
        fail(f"serve/C: the producer failed: {over.error!r}")
    wall_c = time.perf_counter() - t0
    _wait_for(lambda: len(sched.queue) == 0, 120, "arm C to drain")
    torch.cuda.synchronize()
    launches_c = launch_counts()
    shapes_c = launch_shapes()
    _stop_cli(stop, t, box, "A")
    if elector.lock.get().holder_identity != "":
        fail("serve/A: the lease was not released on shutdown")
    # -- checks ---------------------------------------------------------
    dbg = hooks["cycles"].debug_result
    if dbg is None:
        fail("serve/A: the sync-debug cycle never ran")
    if dbg.solver_tier != "batch" or dbg.solver_fallbacks \
            or dbg.scheduled != dbg.attempted:
        fail(f"serve/A: the sync-debug cycle was not clean: tiers "
             f"{dbg.tier_attempts}, bound {dbg.scheduled} of {dbg.attempted}")
    all_results = hooks["results"]
    a_results = all_results[n_warm:n_a_end]
    _bound_once("A", prod.pods, all_results)
    _bound_once("A", extra.pods, all_results)
    _bound_once("C", over.pods, all_results)
    _live_capacity("A", nodes, bound, [prod, over])
    for _, r in all_results:
        if r.attempted and r.flush_trigger not in ("bucket-fill",
                                                   "max-wait"):
            fail(f"serve/A: a cycle flushed by {r.flush_trigger!r}")
        if r.attempted and (r.solver_tier != "batch" or r.solver_fallbacks):
            fail(f"serve/A: a cycle solved on {r.solver_tier!r} after "
                 f"{r.solver_fallbacks} fallbacks")
    captures_after = sum(r.graph_captures for _, r in all_results)
    if captures_after:
        fail(f"serve/A: {captures_after} round-loop graphs captured after "
             "warmup")
    if launches_a["fused_pair_normalize"] <= 0:
        fail("serve/A: the fused-pair kernel was never launched")
    if over.shed <= 0:
        fail("serve/C: the overload shed no create")
    offered_rate = (over.offered + len(over.deleted)) / wall_c
    a_rate = (len(prod.pods) + len(prod.deleted)) / wall_a
    if offered_rate < 4 * a_rate:
        fail(f"serve/C: offered {offered_rate:.0f} ops/s, under 4x arm A's "
             f"{a_rate:.0f}")
    lat_a = [v for _, r in a_results for k, v in r.e2e_latency_s.items()
             if k in prod.pods]
    lat_j = [v for k, v in journey_e2e if k in prod.pods]
    # every churn pod that bound closed its journey (beyond the tracker's
    # pending cap a pod is counted as dropped, not tracked)
    bound_a = {k for _, r in a_results for k in r.assignments
               if k in prod.pods}
    untracked = bound_a - {k for k, _ in journey_e2e}
    if len(untracked) > sched.obs.journeys.dropped_total:
        fail(f"serve/A: {len(untracked)} bound pods closed no journey "
             f"({sched.obs.journeys.dropped_total} dropped at the cap)")
    lat_c = [v for _, r in all_results[n_c_start:]
             for k, v in r.e2e_latency_s.items() if k in over.pods]
    a_rows = _serve_cycles(a_results)
    a_rows.update({
        "created": len(prod.pods), "deleted": len(prod.deleted),
        "wall_s": wall_a, "p50_s": _pct(lat_a, 50), "p99_s": _pct(lat_a, 99),
        "journey_p50_s": _pct(lat_j, 50), "journey_p99_s": _pct(lat_j, 99),
        "journeys_bound": len(lat_j), "debug_routes": debug_routes,
        "soak": soak,
        "pods_bound_per_s": len(prod.pods) / wall_a,
        "ops_per_s": (len(prod.pods) + len(prod.deleted)) / wall_a,
        "max_queue_depth": prod.max_queue_depth,
        "warmup_cycles": n_warm, "graph_captures_warmup": warm_captures,
        "graph_captures_after_warmup": captures_after,
        "sync_debug_cycle": {"attempted": dbg.attempted,
                             "host_syncs": dbg.host_syncs,
                             "tiers": dbg.tier_attempts, "clean": True},
        "profiled_cycle": hooks["cycles"].profile_out,
        "launches_warmup": launches_warm, "launches": launches_a,
        "shapes": shapes_a, "shapes_warmup": shapes_warm,
        "doorbell_rings": rt.bell.rings_total})
    offered = over.offered + len(over.deleted)
    c_rows = {"offered_creates": over.offered, "admitted": len(over.pods),
              "shed": over.shed, "shed_rate": over.shed / max(over.offered, 1),
              "offered_ops_per_s": offered / wall_c,
              "offered_vs_arm_a": (offered / wall_c)
              / max(a_rows["ops_per_s"], 1e-9),
              "p99_admitted_s": _pct(lat_c, 99),
              "p50_admitted_s": _pct(lat_c, 50),
              "max_queue_depth": over.max_queue_depth,
              "max_undelivered_events": over.max_undelivered,
              "shed_bound": rt.shed_bound(), "wall_s": wall_c,
              # scripts/bench_churn.py's overload criteria, reported (not
              # gated): admission reads the scheduler's queue, and the
              # creates it admitted while they sat in this arm's informer
              # buffer reach the queue only at the next delivery
              "bench_churn_criteria": {
                  "queue_bounded_ok": over.max_queue_depth
                  <= rt.shed_bound() + SERVE_RATE,
                  "p99_bounded_ok": (_pct(lat_c, 99) or 0.0) < 2.0},
              "flow": rt.flow.stats(), "launches": launches_c}
    return {"A": a_rows, "C": c_rows,
            "launches": {k: launches_warm.get(k, 0) + launches_a.get(k, 0)
                         + launches_c.get(k, 0) for k in launches_a},
            "cycles": len(all_results),
            "shapes": _merge_shapes(shapes_warm, shapes_a, shapes_c)}


def serve_arm_b(tmp: str, nodes, bound) -> dict:
    """Arm B, the legacy loop: the same ``cli.run`` with
    ``serving.enabled: false`` and ``--cycle-interval 0.25`` at
    SERVE_RATE for 20 s (bench_churn's fixed arm). The legacy loop has
    no ingest lock, so the producer and every cycle share one."""
    import random
    import threading

    import torch

    _path, cfg = _serve_config(
        tmp, "serve-b", serving={"enabled": False},
        warmup={"enabled": True, "podBuckets": [8, 16, 32, 64, 128, 256,
                                                512, 1024]})
    lock = threading.RLock()
    rng = random.Random(21)
    sample = [serve_pod(f"warm-{i}", i, rng) for i in range(64)]
    hooks: dict = {}

    def on_ready(ctx):
        sched = ctx["sched"]
        sched.binder = ConfirmingBinder(sched)
        feed(sched, nodes, bound, sample)
        results = hooks["results"] = []
        real = sched.schedule_cycle

        def cycle(*a, **kw):
            with lock:
                r = real(*a, **kw)
            results.append((time.perf_counter(), r))
            if "prod" in hooks:
                hooks["prod"].on_cycle(r)
            return r

        sched.schedule_cycle = cycle
        real_idle = sched.idle_tick

        def idle():
            with lock:
                real_idle()

        sched.idle_tick = idle

    stop, t, box = _run_cli(cfg, ["--device", "cuda", "--cycle-interval",
                                  "0.25"], on_ready)
    sched = box["sched"]
    _wait_for(lambda: sched.cache.pod_count() >= len(bound) + len(sample),
              300, "the legacy loop's lease, warmup and first cycle")

    def ingest(fn, *a):
        with lock:
            return fn(*a)

    prod = Churn(ingest, sched, "fx", seed=22, duration=20.0)
    hooks["prod"] = prod
    n0 = len(hooks["results"])
    t0 = time.perf_counter()
    prod.run()
    if prod.error:
        fail(f"serve/B: the producer failed: {prod.error!r}")
    _wait_for(lambda: len(sched.queue) == 0, 60, "arm B to drain")
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = launch_counts()
    shapes = launch_shapes()
    _stop_cli(stop, t, box, "B")
    results = hooks["results"]
    _bound_once("B", prod.pods, results)
    _live_capacity("B", nodes, bound, [prod])
    lat = [v for _, r in results[n0:] for k, v in r.e2e_latency_s.items()
           if k in prod.pods]
    rows = _serve_cycles(results[n0:])
    rows.update({"created": len(prod.pods), "deleted": len(prod.deleted),
                 "wall_s": wall, "p50_s": _pct(lat, 50),
                 "p99_s": _pct(lat, 99),
                 "pods_bound_per_s": len(prod.pods) / wall,
                 "launches": launches})
    return {"B": rows, "launches": launches, "cycles": len(results),
            "shapes": shapes}


class SharedBinder:
    """The truth both failover replicas bind through: a CAS that refuses
    a second bind of a key (counted as a double-bind attempt)."""

    def __init__(self) -> None:
        import threading

        self.lock = threading.Lock()
        self.bound: dict = {}
        self.double_bind_attempts = 0

    def bind(self, pod, node_name: str) -> None:
        with self.lock:
            if pod.key() in self.bound:
                self.double_bind_attempts += 1
                raise RuntimeError(f"{pod.key()} is already bound to "
                                   f"{self.bound[pod.key()]}")
            self.bound[pod.key()] = node_name


def serve_arm_d(tmp: str, nodes, bound) -> dict:
    """Arm D, failover: two ServingRuntimes on the same card share one
    InMemoryLock and bind through one SharedBinder (``solver:
    sinkhorn``, fenced binds and takeover reconciliation on, the lease
    cut to SERVE_LEASE). Both replicas are fed every create; each cycle's
    binds are relayed to the peer as watch MODIFIED events when the
    cycle ends. At 40% of a 20 s run of creates at half SERVE_RATE
    (bench_churn's failover arm) the leader is killed the way
    ``chaos.CrashLoop`` kills: ``chaos.KillingBinder`` raises
    ``SchedulerKilled`` just after a bind's CAS committed, so the cycle
    dies with binds in the truth that the standby never heard of, and the
    lease is not released. The standby's takeover reconcile must adopt
    every such bind (else it would bind them again, which the CAS counts
    as a double bind)."""
    import dataclasses
    import math
    import random
    import threading

    import torch

    from kubernetes_tpu_torch.chaos import CrashPlan, KillingBinder, \
        SchedulerKilled
    from kubernetes_tpu_torch.leaderelection import InMemoryLock, \
        LeaderElector
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.serving import ServingRuntime

    _path, cfg = _serve_config(tmp, "serve-d", solver="sinkhorn",
                               leaderElection={"leaderElect": True,
                                               **SERVE_LEASE})
    truth = SharedBinder()
    lock = InMemoryLock()
    rng = random.Random(31)
    sample = [serve_pod(f"warm-{i}", i, rng) for i in range(64)]
    pods: dict = {}

    def lister():
        with truth.lock:
            placed = dict(truth.bound)
        return [dataclasses.replace(p, node_name=placed.get(k, ""))
                for k, p in list(pods.items())]

    class Replica:
        def __init__(self, name):
            self.name = name
            self.sched = Scheduler.from_config(cfg)
            # armed by raising max_kills: then each bind's CAS is
            # followed by a kill with probability 1/20 (seeded), so the
            # kill tends to land inside a micro-batch, after some of its
            # binds committed
            self.plan = CrashPlan(seed=8, sites=("bind:post",),
                                  kill_rate=0.05, max_kills=0)
            self.sched.binder = KillingBinder(
                ConfirmingBinder(self.sched, truth), self.plan)
            feed(self.sched, nodes, bound, [])
            self.rt = ServingRuntime(self.sched, cfg.serving,
                                     warmup=cfg.warmup)
            self.rt.warm_if_pending(sample_pods=sample)
            self.elector = self.rt.attach_elector(
                LeaderElector(name, lock, cfg.leader_election),
                lister=lister)
            self.stop = threading.Event()
            self.results: list = []
            self.dead = False
            self.killed_at = None
            self.peer = None
            self.error = None
            self.rt.loop.on_cycle = self.on_cycle

        def on_cycle(self, res):
            self.results.append((time.perf_counter(), res))
            peer = self.peer
            if peer is not None and not peer.dead:
                for key, node in res.assignments.items():
                    old = pods[key]
                    peer.rt.loop.ingest(
                        peer.sched.on_pod_update, old,
                        dataclasses.replace(old, node_name=node))

        def run(self):
            try:
                self.rt.run(self.stop, elector=self.elector,
                            retry_period_s=cfg.leader_election
                            .retry_period_s)
            except SchedulerKilled:
                self.killed_at = time.perf_counter()
                self.dead = True
            except BaseException as e:  # re-raised below
                self.error = e

    a, b = Replica("replica-a"), Replica("replica-b")
    a.peer, b.peer = b, a
    if not a.elector.tick():
        fail("serve/D: replica a did not take the lease")
    threads = [threading.Thread(target=r.run, name=r.name, daemon=True)
               for r in (a, b)]
    duration, kill_frac = 20.0, 0.4
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    armed = False
    created = 0
    prng = random.Random(32)
    next_burst = time.monotonic()
    m0 = time.monotonic()
    while time.monotonic() - m0 < duration:
        now = time.monotonic()
        if not armed and now - m0 >= duration * kill_frac:
            a.plan.max_kills = 1  # the leader's next bind kills it
            armed = True
        if now < next_burst:
            time.sleep(next_burst - now)
        next_burst += 0.1
        target = int(SERVE_RATE / 2 * (min(time.monotonic(),
                                           m0 + duration) - m0))
        while created < target:
            pod = serve_pod(f"fo-{created}", created, prng)
            pod.queued_at = time.monotonic()
            pods[pod.key()] = pod
            for r in (a, b):
                if not r.dead:
                    r.rt.loop.ingest(r.sched.on_pod_add,
                                     dataclasses.replace(pod))
            created += 1
    _wait_for(lambda: a.dead or a.error is not None, 30, "the leader's kill")
    if a.error is not None:
        raise a.error
    kill_t = a.killed_at
    _wait_for(lambda: len(truth.bound) >= created or b.error is not None, 90,
              "the standby to bind every pod")
    wall = time.perf_counter() - t0
    for r in (a, b):
        r.stop.set()
    for th in threads:
        th.join(timeout=60)
        if th.is_alive():
            fail("serve/D: a replica did not stop")
    for r in (a, b):
        if r.error is not None:
            raise r.error
    torch.cuda.synchronize()
    launches = launch_counts()
    shapes = launch_shapes()
    if truth.double_bind_attempts:
        fail(f"serve/D: {truth.double_bind_attempts} double binds")
    missing = [k for k in pods if k not in truth.bound]
    if missing:
        fail(f"serve/D: {len(missing)} pods never bound")
    placed = {}
    for r in (a, b):
        for _, res in r.results:
            for k, node in res.assignments.items():
                if k in placed:
                    fail(f"serve/D: {k} bound twice")
                placed[k] = node
    # the killed cycle's binds: in the truth, in no finished cycle
    torn = sorted(k for k in truth.bound if k not in placed)
    recheck_capacity(nodes, bound, dict(truth.bound), pods)
    mb = b.sched.metrics
    ma = a.sched.metrics
    recovery = {
        "takeovers_b": mb.recovery_takeovers.value(),
        "adopted": mb.recovery_adopted.value(),
        "forgotten": mb.recovery_forgotten.value(),
        "requeued": mb.recovery_requeued.value(),
        "fenced_binds": (ma.recovery_fenced_binds.value()
                         + mb.recovery_fenced_binds.value()),
        "drained": (ma.recovery_drained.value()
                    + mb.recovery_drained.value())}
    actions = sum(v for k, v in recovery.items() if k != "takeovers_b")
    if not torn:
        fail("serve/D: the kill left no bind in flight")
    if actions <= 0:
        fail("serve/D: no reconcile action, fenced or drained pod on "
             "takeover")
    if recovery["adopted"] < len(torn):
        fail(f"serve/D: the standby adopted {recovery['adopted']:.0f} of "
             f"the {len(torn)} binds the killed cycle committed")
    if launches["sinkhorn_u"] <= 0 or launches["sinkhorn_v"] <= 0:
        fail("serve/D: the Sinkhorn kernels were never launched")
    # the Sinkhorn families: one sample per flight record whose plan ran
    # (the stats ride each solve's readback), on both replicas; the
    # standby's first record after the kill carries the takeover
    stats = {}
    for r in (a, b):
        recs = r.sched.obs.recorder.records()
        planned = sum(1 for rec in recs if rec.sinkhorn_iters >= 0)
        m = r.sched.metrics
        if (not planned or m.sinkhorn_iterations.count() < planned
                or not math.isfinite(m.sinkhorn_residual.value())):
            fail(f"serve/D: {r.name}: {planned} planned records, "
                 f"{m.sinkhorn_iterations.count()} iteration samples")
        stats[r.name] = {"records": r.sched.obs.recorder.recorded,
                         "samples": m.sinkhorn_iterations.count(),
                         "final_residual": m.sinkhorn_residual.value()}
    if not any(rec.takeover for rec in b.sched.obs.recorder.records()):
        fail("serve/D: no standby flight record carries the takeover")
    post = [(s, r) for s, r in b.results if s > kill_t and r.scheduled]
    if not post:
        fail("serve/D: the standby never bound after the kill")
    first = min(s for s, _ in post)
    settle = first + max(1.0, 0.15 * duration)
    lats = [v for s, r in b.results if s >= settle
            for v in r.e2e_latency_s.values()]
    for r in (a, b):
        for _, res in r.results:
            if res.attempted and res.flush_trigger not in ("bucket-fill",
                                                           "max-wait"):
                fail(f"serve/D: a cycle flushed by {res.flush_trigger!r}")
    rows = {"created": created, "bound": len(truth.bound), "wall_s": wall,
            "kill_after_s": kill_t - t0, "takeover_s": first - kill_t,
            "leader_cycles_before_kill": len(a.results),
            "standby_cycles_after_kill": len(post),
            "p99_after_recovery_s": _pct(lats, 99),
            "p50_after_recovery_s": _pct(lats, 50),
            "p99_before_kill_s": _pct([v for _, r in a.results
                                       for v in r.e2e_latency_s.values()],
                                      99),
            "double_binds": truth.double_bind_attempts,
            "torn_binds": len(torn), "recovery": recovery,
            "sinkhorn_stats": stats,
            "tiers": sorted({r.solver_tier for rep in (a, b)
                             for _, r in rep.results if r.attempted}),
            "launches": launches, "shapes": shapes}
    cycles = len(a.results) + len(b.results)
    del a, b
    return {"D": rows, "launches": launches, "cycles": cycles}


def serve_arm_e(tmp: str, nodes, bound) -> dict:
    """Arm E: ``python -m kubernetes_tpu_torch --config f.json --port P
    --lock-file L`` as a process on the card (``/healthz`` answers ``ok``,
    ``/metrics`` carries ``scheduler_schedule_attempts_total``, the lock
    file appears, SIGTERM ends it with rc 0); then ``serve_scheduler``
    with an ``ExtenderServer`` over the 5000-node cluster on 127.0.0.1
    answers 64 ``filter`` and 64 ``prioritize`` POSTs, each equal to the
    same scheduler's answer on CPU tensors."""
    import http.client
    import random
    import signal
    import socket
    import urllib.request

    from kubernetes_tpu_torch.extender import pod_to_json
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.server import ExtenderServer, serve_scheduler

    # the process
    path, _cfg = _serve_config(tmp, "serve-e")
    lock = os.path.join(tmp, "serve-e.lock")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    saved = {k: os.environ.pop(k) for k in list(os.environ)
             if k.lower() in ("http_proxy", "https_proxy", "all_proxy")}
    os.environ["no_proxy"] = os.environ["NO_PROXY"] = "127.0.0.1,localhost"
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubernetes_tpu_torch", "--config", path,
         "--port", str(port), "--lock-file", lock],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        body = None
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                fail(f"serve/E: the process exited rc={proc.returncode}: "
                     f"{proc.stderr.read().decode()[-800:]}")
            try:
                body = urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=2).read()
                break
            except OSError:
                time.sleep(0.2)
        healthz_s = time.perf_counter() - t0
        if body != b"ok":
            fail(f"serve/E: /healthz answered {body!r}")
        metrics = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=5).read().decode()
        if "scheduler_schedule_attempts_total" not in metrics:
            fail("serve/E: /metrics lacks scheduler_schedule_attempts_total")
        while not os.path.exists(lock) and time.monotonic() < deadline:
            time.sleep(0.2)
        if not os.path.exists(lock):
            fail("serve/E: the lock file never appeared")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        if rc != 0:
            fail(f"serve/E: SIGTERM ended the process with rc {rc}: "
                 f"{proc.stderr.read().decode()[-800:]}")
        with open(lock) as f:
            lease = json.load(f)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    # the extender, in process
    scheds = {}
    for dev in ("cuda", "cpu"):
        sched = Scheduler(device=dev)
        feed(sched, nodes, bound, [])
        scheds[dev] = sched
    srv = serve_scheduler(scheds["cuda"],
                          extender=ExtenderServer(scheds["cuda"]))
    ref = ExtenderServer(scheds["cpu"])
    names = scheds["cpu"].cache.node_order()
    rng = random.Random(41)
    ms: dict = {"filter": [], "prioritize": []}
    try:
        conn = http.client.HTTPConnection("127.0.0.1",
                                          srv.server_address[1], timeout=60)
        for i in range(64):
            pod = serve_pod(f"ext-{i}", i, rng)
            body = {"pod": pod_to_json(pod)}
            if i % 4 == 3:
                body["pod"]["spec"]["nodeSelector"] = {
                    ZONE: f"zone-{i % 10}"}
            if i % 2:
                body["nodenames"] = names[i::7]
            for verb in ("filter", "prioritize"):
                raw = json.dumps(body)
                t1 = time.perf_counter()
                conn.request("POST", f"/scheduler/{verb}", raw,
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                got = json.loads(resp.read())
                ms[verb].append((time.perf_counter() - t1) * 1e3)
                want = json.loads(json.dumps(ref.handle(
                    verb, json.loads(raw))))
                if resp.status != 200 or got != want:
                    fail(f"serve/E: {verb} of {pod.key()} differs from the "
                         "CPU tensors' answer")
        conn.close()
    finally:
        srv.shutdown()
        srv.server_close()
        os.environ.update(saved)
    return {"E": {"process": {"healthz_after_s": healthz_s, "rc": rc,
                              "lease_after_shutdown": lease},
                  "extender": {"calls": 128, "equal_to_cpu": True,
                               "filter_ms_p50": _pct(ms["filter"], 50),
                               "prioritize_ms_p50": _pct(ms["prioritize"],
                                                         50),
                               "filter_ms_max": max(ms["filter"]),
                               "prioritize_ms_max": max(
                                   ms["prioritize"])}}}


def phase_serve() -> dict:
    """The serve loop, cell ``serve-5k-churn``: the smoke cluster (5000
    nodes, 1000 bound pods) under create/delete churn, arms A-E (see
    each). Every configuration is a JSON v1alpha1 document written to a
    temporary directory. Returns the launches of arms A-D (the serve
    path: counted from 0 before arm A's ``cli.run`` starts, read at each
    arm's end) and their cycle count."""
    import tempfile

    import torch

    from kubernetes_tpu_torch import kernels

    nodes, bound, _pending = smoke_cell(n_pending=0)
    out = {}
    launches: dict = {}
    cycles = 0
    with tempfile.TemporaryDirectory(prefix="ktt-serve-") as tmp:
        kernels.reset_launches()
        ac = serve_arm_ac(tmp, nodes, bound)
        emit({"phase": "serve", "arm": "A", "cell": "serve-5k-churn",
              **ac["A"]})
        emit({"phase": "serve", "arm": "C", "cell": "serve-5k-churn",
              **ac["C"]})
        release_graphs()
        kernels.reset_launches()
        b = serve_arm_b(tmp, nodes, bound)
        emit({"phase": "serve", "arm": "B", "cell": "serve-5k-churn",
              **b["B"]})
        release_graphs()
        kernels.reset_launches()
        d = serve_arm_d(tmp, nodes, bound)
        emit({"phase": "serve", "arm": "D", "cell": "serve-5k-churn",
              **d["D"]})
        release_graphs()
        e = serve_arm_e(tmp, nodes, bound)
        emit({"phase": "serve", "arm": "E", "cell": "serve-5k-churn",
              **e["E"]})
        for got in (ac, b, d):
            cycles += got["cycles"]
            for k, v in got["launches"].items():
                launches[k] = launches.get(k, 0) + v
    torch.cuda.empty_cache()
    return {"launches": launches, "cycles": cycles,
            "shapes": _merge_shapes(ac["shapes"], b["shapes"],
                                    d["D"]["shapes"])}


# ---------------------------------------------------------------------------
# phase 13: the hollow cluster, its informer and the REST registry
# ---------------------------------------------------------------------------

#: cell ``hollow-5k-controllers``, arm A: kubemark's and scheduler_perf's
#: 5000 nodes of the smoke cell's shape. The pod count is cut from the
#: reference bench's 30,000 (PERF.md §4): every kubelet's sync scans the
#: whole truth map (``HollowKubelet.pods``), so a hub step costs host time
#: in proportion to nodes x pods. The StatefulSet's ordinals bind two
#: steps apart, so its size sets the bind steps: 5 until the mesh phase
#: came, 3 since (four fewer 5-10 s steps pay for that phase), 2 since
#: the mesh phase's arm E (two fewer steps pay for it), 1 since the
#: route phase (two fewer steps pay for it, 23-41 s each on the slowest
#: host seen; the churn steps cannot go: the killed kubelets' pods are
#: evicted only at the third). The equality arm's StatefulSet of 3 still
#: binds its ordinals in order on the card against the CPU
HOLLOW_FULL = {"n_nodes": 5000, "n_deploy": 2500, "n_job": 500, "n_sts": 1}
#: the CUDA-against-CPU run: arm A's traffic at 500 nodes and 3000 pods
HOLLOW_REDUCED = {"n_nodes": 500, "n_deploy": 1995, "n_job": 500,
                  "n_sts": 3}
HOLLOW_CHURN_STEPS = 3
HOLLOW_KILLED_KUBELETS = 50
#: an arm B step is a minute of hub time: a pod whose bind failed leaves
#: the unschedulable queue at its next 60 s flush, one step later
HOLLOW_MINUTE_DT = 60.0
#: a churn step is 320 s of hub time, so the 3 churn steps still cover the
#: kubelet outage: the killed kubelets' nodes are tainted unreachable at
#: the second step (the 40 s grace passed) and their pods evicted at the
#: third (the 300 s default toleration ran out); the kubelets are healed
#: after it, and arm B's first step on the same hub restores their nodes
HOLLOW_CHURN_DT = 320.0
#: arm B: pods created over REST, half for each scheduler
HOLLOW_REST_PODS = 2000


def hollow_hub(device="cuda", n_nodes=5000, n_deploy=2500, n_job=500,
               n_sts=5, seed=7):
    """Arm A's hub: ``HollowCluster`` with admission, one tick of watch
    delay, a competing writer and flaky binds; its scheduler on
    ``device`` at its defaults. The smoke cell's nodes (10 zones, every
    10th with the PreferNoSchedule taint); one DaemonSet (a pod per node,
    pinned by required hostname affinity); ``n_deploy`` pods of 100m /
    500 Mi, half in five Deployments and half bare pods each preferring a
    seeded zone (the hub's Deployment template carries no affinity); a
    Job of ``n_job`` completions run in parallel; a StatefulSet of
    ``n_sts``."""
    import random

    from kubernetes_tpu_torch.sim import (
        DaemonSet,
        Deployment,
        HollowCluster,
        Job,
        StatefulSet,
    )
    from kubernetes_tpu_torch.testing import (
        make_pod,
        node_affinity_preferred,
        req,
    )

    kw = {} if device == "cuda" else {"scheduler_kw": {"device": device}}
    hub = HollowCluster(seed=seed, admission=True, event_delay_ticks=1,
                        competing_bind_rate=0.01, bind_fail_rate=0.01, **kw)
    nodes, _, _ = smoke_cell(n_nodes, 0, 0, seed)
    for nd in nodes:
        hub.add_node(nd)
    hub.add_daemonset(DaemonSet("node-agent"))
    half = n_deploy // 2
    for i in range(5):
        hub.add_deployment(Deployment(
            f"web-{i}", replicas=half // 5 + (i < half % 5),
            cpu_milli=100, memory=500 * 2**20))
    rng = random.Random(seed)
    for i in range(n_deploy - half):
        hub.create_pod(make_pod(
            f"zonal-{i}", cpu_milli=100, memory=500 * 2**20,
            affinity=node_affinity_preferred(
                (50, [req(ZONE, "In", f"zone-{rng.randrange(10)}")]))))
    hub.add_job(Job("batch", completions=n_job, parallelism=n_job))
    hub.add_statefulset(StatefulSet("db", replicas=n_sts))
    return hub


class HollowProbe:
    """Times a hub's steps from outside: the wall seconds of each step,
    of the scheduling cycle inside it (``schedule_cycle`` wrapped) and of
    its solve (:func:`SolveTimer`: the hub's clock is simulated, so
    ``CycleResult.solve_s`` and the trace's spans read 0), and the pods
    the node-lifecycle controller evicted (``monitor_node_health``
    wrapped)."""

    def __init__(self, hub, tier: str = "batch") -> None:
        self.hub, self.tier = hub, tier
        self.res, self.cycle_s, self.evicted = None, 0.0, 0
        self.solve = SolveTimer(hub.sched)
        cycle, health = hub.sched.schedule_cycle, hub.monitor_node_health

        def timed_cycle(*a, **k):
            t0 = time.perf_counter()
            self.res = cycle(*a, **k)
            self.cycle_s = time.perf_counter() - t0
            return self.res

        def counted_health():
            n0 = len(hub.truth_pods)
            health()
            self.evicted += n0 - len(hub.truth_pods)

        hub.sched.schedule_cycle = timed_cycle
        hub.monitor_node_health = counted_health

    def step(self, kind: str, dt: float = 15.0) -> dict:
        hub = self.hub
        c0, e0 = hub.binder.conflicts, self.evicted
        self.solve.take()
        t0 = time.perf_counter()
        hub.step(dt)
        step_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        hub.check_consistency()
        check_s = time.perf_counter() - t1
        r = self.res
        if r.solver_tier not in ("", self.tier) or r.solver_fallbacks:
            fail(f"hollow: a cycle solved on tier {r.solver_tier!r} after "
                 f"{r.solver_fallbacks} fallbacks")
        solve_s = self.solve.take()
        return {"kind": kind, "step_s": step_s, "cycle_s": self.cycle_s,
                "solve_s": solve_s, "controllers_s": step_s - self.cycle_s,
                "check_s": check_s, "pods": len(hub.truth_pods),
                "bound": sum(1 for p in hub.truth_pods.values()
                             if p.node_name),
                "attempted": r.attempted, "scheduled": r.scheduled,
                "conflicts": hub.binder.conflicts - c0,
                "evictions": self.evicted - e0, "rounds": r.rounds,
                "revision": hub._revision}


def hollow_drive(probe, n_sts: int, seed: int = 7, max_bind_steps: int = 40,
                 profile_step: bool = False):
    """Steps the probe's hub until every pod is bound (the StatefulSet's
    last ordinal included), then ``HOLLOW_CHURN_STEPS`` churn steps of
    ``HOLLOW_CHURN_DT``: each kills 200 bound pods and removes 5 nodes
    (``hub.churn``); the first kills ``HOLLOW_KILLED_KUBELETS`` kubelets
    (their nodes are tainted at the second, their pods evicted at the
    third); after the last they are healed (the next step on the hub,
    arm B's, restores their nodes).
    ``check_consistency`` after every step. Returns the per-step rows,
    the per-step truth (bindings, revision, bound count) and, with
    ``profile_step``, the device's busy share of one profiled bind
    step."""
    import random

    hub = probe.hub
    rows, truths, prof = [], [], None

    def record(row):
        rows.append(row)
        truths.append(({k: p.node_name for k, p in hub.truth_pods.items()},
                       hub._revision, row["bound"]))

    for k in range(max_bind_steps):
        if profile_step and k == 1:
            import torch
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as p:
                row = probe.step("bind")
                torch.cuda.synchronize()
            prof = {"step": k, **busy_share(p, time.perf_counter() - t0)}
        else:
            row = probe.step("bind")
        record(row)
        sts = [p for key, p in hub.truth_pods.items()
               if key.startswith("default/db-")]
        if (hub.pending_count() == 0 and len(sts) == n_sts
                and row["attempted"] == 0):
            break
    else:
        fail(f"hollow: {hub.pending_count()} pods still pending after "
             f"{max_bind_steps} steps")
    rng = random.Random(seed)
    victims = rng.sample(sorted(hub.truth_nodes), HOLLOW_KILLED_KUBELETS)
    for k in range(HOLLOW_CHURN_STEPS):
        hub.churn(kill_pods=200, flap_nodes=5)
        if k == 0:
            for name in victims:
                hub.kill_kubelet(name)
        record(probe.step("churn", HOLLOW_CHURN_DT))
    for name in victims:
        hub.heal_kubelet(name)
    return rows, truths, prof


def hollow_arm_a() -> dict:
    """Arm A: the hub on the card at full width (``HOLLOW_FULL``), one
    profiled bind step; ``debugger.compare`` of the scheduler against the
    truth must be empty at the end."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.api.types import is_pod_terminated
    from kubernetes_tpu_torch.debugger import compare

    t0 = time.perf_counter()
    hub = hollow_hub(**HOLLOW_FULL)
    build_s = time.perf_counter() - t0
    probe = HollowProbe(hub)
    kernels.reset_launches()
    rows, _truths, prof = hollow_drive(probe, HOLLOW_FULL["n_sts"],
                                       profile_step=True)
    launches, shapes = launch_counts(), launch_shapes()
    truth = {k: p.node_name for k, p in hub.truth_pods.items()
             if not is_pod_terminated(p)}
    diffs = compare(hub.sched, truth, list(hub.truth_nodes))
    if diffs[0] or diffs[1]:
        fail(f"hollow: scheduler cache differs from the truth: "
             f"{diffs[0][:3]} {diffs[1][:3]}")
    if launches["fused_pair_normalize"] <= 0:
        fail("hollow: arm A never launched the fused-pair kernel")
    if sum(r["evictions"] for r in rows) <= 0:
        fail("hollow: the killed kubelets' pods were never evicted")
    steps = [r["step_s"] for r in rows]
    host = sum(r["controllers_s"] for r in rows) / sum(steps)
    return {"probe": probe, "launches": launches, "shapes": shapes,
            "cycles": sum(1 for r in rows if r["attempted"]),
            "line": {"build_s": build_s, "steps": len(rows),
                     "bind_steps": sum(r["kind"] == "bind" for r in rows),
                     "rows": rows, "step_s_p50": _pct(steps, 50),
                     "step_s_max": max(steps), "host_share": host,
                     "pods_created": hub.bound_total,
                     "conflicts": hub.binder.conflicts,
                     "competing_bound": hub.competing_bound,
                     "evictions": sum(r["evictions"] for r in rows),
                     "profiled_step": prof, "launches": launches}}


def hollow_equality() -> dict:
    """Arm A's traffic at ``HOLLOW_REDUCED``, the hub's scheduler on the
    card and then on CPU tensors: after every step the truth bindings,
    the hub revision and the bound count must be equal."""
    runs = {}
    for dev in ("cuda", "cpu"):
        hub = hollow_hub(device=dev, **HOLLOW_REDUCED)
        _rows, truths, _ = hollow_drive(HollowProbe(hub),
                                        HOLLOW_REDUCED["n_sts"])
        runs[dev] = truths
    a, b = runs["cuda"], runs["cpu"]
    if len(a) != len(b):
        fail(f"hollow: CUDA ran {len(a)} steps, CPU {len(b)}")
    for k, (x, y) in enumerate(zip(a, b)):
        if x != y:
            fail(f"hollow: step {k}: CUDA and CPU truth differ "
                 f"(revision {x[1]} vs {y[1]}, bound {x[2]} vs {y[2]})")
    return {"steps": len(a), "pods": len(a[-1][0]), "revision": a[-1][1],
            "bound": a[-1][2]}


class WatchClient:
    """An NDJSON watch client of ``/api/v1/watch/pods`` over kubectl's
    ``RestClient``, scoped by a label selector: each poll resumes at the
    resourceVersion the last frame carried; a 410 relists
    (``GET /api/v1/pods``) and resumes at the list's revision. It counts
    each pod's bindings (its node going from empty to set) and fails on a
    frame at or below a revision it already saw for that pod."""

    def __init__(self, rest, selector: str) -> None:
        self.rest, self.selector = rest, selector
        self.node: dict = {}
        self.rv_of: dict = {}
        self.bindings: dict = {}
        self.bound_at: dict = {}
        self.gone = self.polls = 0
        self.rv = self._relist(count=False)

    def _see(self, key, node, rv) -> None:
        if rv <= self.rv_of.get(key, 0):
            fail(f"hollow: watch frame for {key} at rv {rv} repeats rv "
                 f"{self.rv_of[key]}")
        self.rv_of[key] = rv
        if node and not self.node.get(key):
            self.bindings[key] = self.bindings.get(key, 0) + 1
            self.bound_at.setdefault(key, time.perf_counter())
        self.node[key] = node

    def _relist(self, count: bool = True) -> int:
        code, doc = self.rest.call(
            "GET", f"/api/v1/pods?labelSelector={self.selector}")
        if code != 200:
            fail(f"hollow: relist answered {code}: {doc}")
        if count:
            self.gone += 1
        for item in doc["items"]:
            m = item["metadata"]
            key = f"{m['namespace']}/{m['name']}"
            rv = int(m["resourceVersion"])
            if rv > self.rv_of.get(key, 0):
                self._see(key, item["spec"].get("nodeName", ""), rv)
        return int(doc["metadata"]["resourceVersion"])

    def poll(self) -> None:
        import http.client

        self.polls += 1
        conn = http.client.HTTPConnection(self.rest.host, self.rest.port,
                                          timeout=30)
        conn.request("GET", f"/api/v1/watch/pods?resourceVersion={self.rv}"
                            f"&labelSelector={self.selector}")
        r = conn.getresponse()
        data = r.read()
        conn.close()
        if r.status == 410:
            self.rv = self._relist()
            return
        if r.status != 200:
            fail(f"hollow: watch answered {r.status}: {data[:200]!r}")
        for line in data.splitlines():
            if not line.strip():
                continue
            ev = json.loads(line)
            m = ev["object"]["metadata"]
            rv = int(m["resourceVersion"])
            self.rv = max(self.rv, rv)
            if ev["type"] == "BOOKMARK":
                continue
            key = f"{m['namespace']}/{m['name']}"
            node = ("" if ev["type"] == "DELETED"
                    else ev["object"]["spec"].get("nodeName", ""))
            self._see(key, node, rv)


def proto_call(rest, method: str, path: str, body: bytes = None,
               headers=None):
    """One request to the REST registry with ``Accept:
    application/vnd.kubernetes.protobuf``: ``(status, Content-Type,
    raw body)``."""
    import http.client

    from kubernetes_tpu_torch.api.protobuf import PROTO_CONTENT_TYPE

    conn = http.client.HTTPConnection(rest.host, rest.port, timeout=60)
    conn.request(method, path, body,
                 {"Accept": PROTO_CONTENT_TYPE, **(headers or {})})
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, r.getheader("Content-Type"), data


def rest_protobuf(rest, phase: str, page=None) -> dict:
    """The node and pod lists of the REST registry in protobuf, whole and
    (with ``page``) in pages of ``page`` (continue tokens, ``remaining``),
    each decoded with the port's codec and held against the JSON list's
    objects; then a protobuf-encoded request body, which is read as JSON
    (400) as the reference reads it. Fails on any difference; returns
    the counts and the whole lists' bytes."""
    from kubernetes_tpu_torch.api.protobuf import (
        PROTO_CONTENT_TYPE,
        decode_envelope,
        encode_envelope,
        node_from_pb,
        pod_from_pb,
        pod_to_pb,
    )
    from kubernetes_tpu_torch.extender import node_from_json
    from kubernetes_tpu_torch.proto import corev1
    from kubernetes_tpu_torch.server import pod_from_json
    from kubernetes_tpu_torch.testing import make_pod

    out = {}
    for res, kind, cls, from_pb, from_json in (
            ("nodes", "NodeList", corev1.NodeListMsg, node_from_pb,
             node_from_json),
            ("pods", "PodList", corev1.PodListMsg, pod_from_pb,
             pod_from_json)):
        path = f"/api/v1/{res}"
        code, doc = rest.call("GET", path)
        if code != 200:
            fail(f"{phase}: JSON {path} answered {code}")
        want = [from_json(d) for d in doc["items"]]
        status, ctype, body = proto_call(rest, "GET", path)
        if status != 200 or ctype != PROTO_CONTENT_TYPE:
            fail(f"{phase}: protobuf {path} answered {status} {ctype}")
        whole_bytes = len(body)
        got_kind, raw = decode_envelope(body)
        whole = cls.FromString(raw)
        if (got_kind != kind or whole.continue_token
                or whole.remaining != -1
                or [from_pb(m) for m in whole.items] != want):
            fail(f"{phase}: protobuf {path} differs from the JSON list "
                 f"({got_kind}, {len(whole.items)} of {len(want)} items)")
        pages, items, token = 0, [], ""
        while page:
            q = f"?limit={page}" + (f"&continue={token}" if token else "")
            status, _, body = proto_call(rest, "GET", path + q)
            if status != 200:
                fail(f"{phase}: protobuf page {path}{q} answered {status}")
            lst = cls.FromString(decode_envelope(body)[1])
            items += lst.items
            pages += 1
            left = len(want) - len(items)
            if lst.remaining != (left if lst.continue_token else -1):
                fail(f"{phase}: page {pages} of {path} says "
                     f"remaining={lst.remaining}, {left} left")
            token = lst.continue_token
            if not token:
                break
        if page and [from_pb(m) for m in items] != want:
            fail(f"{phase}: protobuf pages of {path} differ from the JSON "
                 "list")
        out[res] = {"items": len(want), "pages": pages,
                    "protobuf_bytes": whole_bytes,
                    "json_bytes": len(json.dumps(doc))}
    status, _, _ = proto_call(
        rest, "POST", "/api/v1/namespaces/default/pods",
        encode_envelope("Pod", pod_to_pb(make_pod("proto-body"))),
        {"Content-Type": PROTO_CONTENT_TYPE})
    if status != 400:
        fail(f"{phase}: a protobuf request body answered {status}, not 400")
    out["protobuf_body_status"] = status
    return out


def hollow_arm_b(probe, tmp: str) -> dict:
    """Arm B on arm A's hub (stepped through arm A's ``probe``): the REST
    registry on 127.0.0.1 with an audit
    log, a second scheduler built with ``Scheduler.from_config`` (JSON
    v1alpha1: ``schedulerName: second``, ``solver: sinkhorn``,
    ``robustness.watchProgressDeadline: 5s``, and
    ``percentageOfNodesToScore: 100`` for the dense solve, as the
    ``config`` phase sets it) on the card, fed only by a
    ``sim.Reflector`` and binding through the hub's binder. 2000 pods are
    created over REST POST (kubectl's ``RestClient``), half for each
    scheduler; an NDJSON watch client must see every binding once. Then
    a compaction (the watch client gets 410 and relists, the Reflector
    relists), a cursor that eats every frame while the hub advances (the
    Reflector's progress deadline forces a relist), and the node and pod
    lists negotiated in protobuf (``rest_protobuf``)."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.api.types import is_pod_terminated
    from kubernetes_tpu_torch.debugger import compare
    from kubernetes_tpu_torch.extender import pod_to_json
    from kubernetes_tpu_torch.kubectl import RestClient
    from kubernetes_tpu_torch.restapi import AuditLog, RestServer
    from kubernetes_tpu_torch.sim import Reflector
    from kubernetes_tpu_torch.testing import make_pod

    stall = {"on": False}

    class Eater:
        """The stall seam: while ``stall["on"]`` the stream delivers
        nothing (a half-open watch); the cursor itself still advances."""

        def __init__(self, cur) -> None:
            self.cur = cur

        def poll(self):
            got = self.cur.poll()
            return [] if stall["on"] else got

    hub = probe.hub
    audit = AuditLog()
    server = RestServer(hub, audit=audit)
    port = server.serve()
    try:
        sched2 = configured({"schedulerName": "second",
                             "solver": "sinkhorn",
                             "percentageOfNodesToScore": 100,
                             "robustness": {"watchProgressDeadline": "5s"}},
                            tmp, "hollow-second", device="cuda",
                            clock=hub.clock, binder=hub.binder)
        refl = Reflector(hub, sched2, clock=hub.clock, cursor_wrap=Eater)
        if refl.progress_deadline_s != 5.0:
            fail(f"hollow: the Reflector's deadline is "
                 f"{refl.progress_deadline_s}, not the file's 5 s")
        kernels.reset_launches()
        refl.list_and_watch()
        rest = RestClient(f"127.0.0.1:{port}")
        watch = WatchClient(rest, "arm%3Drest")
        keys, create_ms, created_at = [], [], {}
        for i in range(HOLLOW_REST_PODS):
            pod = make_pod(f"rest-{i}", cpu_milli=100, memory=500 * 2**20,
                           labels={"arm": "rest"})
            if i % 2:
                pod.scheduler_name = "second"
            t0 = time.perf_counter()
            code, out = rest.call("POST", "/api/v1/namespaces/default/pods",
                                  pod_to_json(pod))
            create_ms.append((time.perf_counter() - t0) * 1e3)
            if code != 201:
                fail(f"hollow: REST create answered {code}: {out}")
            keys.append(pod.key())
            created_at[pod.key()] = time.perf_counter()
            if i % 200 == 199:
                watch.poll()
        probe_rows, cycles2 = [], []
        for k in range(20):
            with hub.lock:
                row = probe.step("rest", HOLLOW_MINUTE_DT)
                refl.pump()
                t1 = time.perf_counter()
                r2 = sched2.schedule_cycle()
                cyc2_s = time.perf_counter() - t1
                refl.pump()
            if r2.attempted and (r2.solver_tier != "sinkhorn"
                                 or r2.solver_fallbacks):
                fail(f"hollow: the second scheduler solved on "
                     f"{r2.solver_tier!r} after {r2.solver_fallbacks} "
                     "fallbacks")
            cycles2.append(r2.attempted > 0)
            watch.poll()
            probe_rows.append({**row, "cycle2_s": cyc2_s,
                               "attempted2": r2.attempted,
                               "scheduled2": r2.scheduled,
                               "rounds2": r2.rounds})
            if all(watch.node.get(key) for key in keys):
                break
        else:
            fail(f"hollow: {sum(not watch.node.get(k) for k in keys)} REST "
                 "pods unbound after 20 steps")
        once = [k for k in keys if watch.bindings.get(k) != 1]
        if once:
            fail(f"hollow: the watch saw {len(once)} bindings other than "
                 f"once, e.g. {once[:3]}")
        launches = launch_counts()
        shapes = launch_shapes()
        # the second scheduler's plan rounds (arm B's pods take the lean
        # round, so the pair is arm A's to launch)
        for name in ("sinkhorn_u", "sinkhorn_v"):
            if launches[name] <= 0:
                fail(f"hollow: arm B never launched {name}")
        # compaction: the hub advances past the watch client and the
        # Reflector, then compacts; both relist
        relists0, gone0 = refl.relists, watch.gone
        rest.call("POST", "/api/v1/namespaces/default/pods",
                  pod_to_json(make_pod("rest-late", labels={"arm": "rest"})))
        with hub.lock:
            probe.step("rest", HOLLOW_MINUTE_DT)
            hub.compact()
            refl.pump()
        watch.poll()
        if refl.relists <= relists0 or watch.gone <= gone0:
            fail(f"hollow: compaction gave reflector relists "
                 f"{relists0}->{refl.relists}, watch relists "
                 f"{gone0}->{watch.gone}")
        # the stall: the stream eats every frame while the hub advances
        stalled0 = refl.stalled_relists
        stall["on"] = True
        rest.call("POST", "/api/v1/namespaces/default/pods",
                  pod_to_json(make_pod("rest-stall", labels={"arm": "rest"})))
        with hub.lock:
            refl.pump()
            probe.step("rest", HOLLOW_MINUTE_DT)
            refl.pump()
        stall["on"] = False
        if refl.stalled_relists < stalled0 + 1:
            fail("hollow: a stalled watch past the deadline did not relist")
        with hub.lock:
            refl.pump()
            truth = {k: p.node_name for k, p in hub.truth_pods.items()
                     if not is_pod_terminated(p)}
            diffs = compare(sched2, truth, list(hub.truth_nodes))
        if diffs[0] or diffs[1]:
            fail(f"hollow: the Reflector-fed scheduler differs from the "
                 f"truth: {diffs[0][:3]} {diffs[1][:3]}")
        # whole lists only: the grpc phase pages them at full width
        protobuf = rest_protobuf(rest, "hollow")
        lat = [watch.bound_at[k] - created_at[k] for k in keys]
        return {"launches": launches, "shapes": shapes,
                "cycles": sum(cycles2),
                "line": {"rest_pods": len(keys),
                         "create_ms_p50": _pct(create_ms, 50),
                         "create_ms_p99": _pct(create_ms, 99),
                         "create_to_bind_s_p50": _pct(lat, 50),
                         "create_to_bind_s_p99": _pct(lat, 99),
                         "steps": probe_rows, "watch_polls": watch.polls,
                         "watch_relists": watch.gone,
                         "relists": refl.relists,
                         "stalled_relists": refl.stalled_relists,
                         "deduped": refl.deduped,
                         "audit_entries": len(audit.entries),
                         "protobuf": protobuf, "launches": launches}}
    finally:
        server.close()


def phase_hollow() -> dict:
    """Cell ``hollow-5k-controllers``: arm A (the hub on the card at full
    width), the CUDA-against-CPU run, then arm B (the REST registry, the
    Reflector-fed second scheduler) on arm A's hub. Returns the launches
    of arms A and B (each counted from 0 just before it runs)."""
    import tempfile

    t0 = time.perf_counter()
    a = hollow_arm_a()
    emit({"phase": "hollow", "arm": "A", "cell": "hollow-5k-controllers",
          "wall_s": time.perf_counter() - t0, **a["line"]})
    release_graphs()
    t0 = time.perf_counter()
    eq = hollow_equality()
    emit({"phase": "hollow", "arm": "equality",
          "cell": "hollow-5k-controllers",
          "wall_s": time.perf_counter() - t0, **eq})
    release_graphs()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ktt-hollow-") as tmp:
        b = hollow_arm_b(a["probe"], tmp)
    emit({"phase": "hollow", "arm": "B", "cell": "hollow-5k-controllers",
          "wall_s": time.perf_counter() - t0, **b["line"]})
    launches = {k: a["launches"][k] + b["launches"][k]
                for k in a["launches"]}
    return {"launches": launches, "cycles": a["cycles"] + b["cycles"],
            "shapes": _merge_shapes(a["shapes"], b["shapes"])}


def _merge_shapes(*runs) -> dict:
    """Launch shapes of several runs (``launch_shapes()`` each) as one:
    ``{kernel: [[[P, N], launches], ...]}``, the launches of a shape
    summed, the shapes in the order of their first launch."""
    out: dict = {}
    for run in runs:
        for name, shapes in run.items():
            acc = out.setdefault(name, {})
            for shape, n in shapes:
                acc[tuple(shape)] = acc.get(tuple(shape), 0) + n
    return {k: [[list(s), n] for s, n in v.items()] for k, v in out.items()}


# ---------------------------------------------------------------------------
# phase 14: the recovery paths — the ambiguous-bind protocol under network
# chaos, device-loss recovery with host mode, HA failover
# ---------------------------------------------------------------------------

#: arm A's cell ``netchaos-5k`` (the smoke cell's nodes and 2000 of its
#: pending pods: the run takes about 361 steps at any size and the
#: truth-mode audit of every step is O(pods + nodes), so the pods were cut
#: from 10,000 to pay for the ``scenario`` phase) and its CUDA-against-CPU
#: run
NETCHAOS_FULL = {"n_nodes": 5000, "n_pods": 2000}
NETCHAOS_REDUCED = {"n_nodes": 500, "n_pods": 1000}
#: arm B's cell ``devloss-5k``: the smoke cluster, six cycles of a batch
DEVLOSS = {"n_nodes": 5000, "n_bound": 1000, "batch": 1024, "cycles": 6}
#: arm C's cell ``ha-5k``: pods created in batches, the leader killed after
#: half of them
HA = {"n_nodes": 5000, "n_pods": 2000, "batches": 10}
#: the reference's failover lease (tests/test_crash_recovery.py ``_LE``)
HA_LEASE = {"lease_duration_s": 15, "renew_deadline_s": 10,
            "retry_period_s": 2}


def _sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def _launches_since(before: dict) -> dict:
    """The array kernels' launches since ``before`` (a ``launch_counts()``
    read)."""
    now = launch_counts()
    return {k: now[k] - before.get(k, 0)
            for k in ARRAY_KERNELS + SPLIT_KERNELS}


def netchaos_run(device: str, n_nodes: int, n_pods: int,
                 solver: str = "batch", seed: int = 7) -> dict:
    """One ``chaos.NetChaos`` run at the reference's default fault rates
    on a ``sim.HollowCluster(seed)`` the caller's shape fills: the smoke
    cell's nodes and ``n_pods`` of its zone-preferring pending pods (half
    tolerating the taint), driven by ``run(n_pods=0, n_nodes=0)``. Fails
    unless it converged with every pod bound, no double-bind attempt, no
    auditor violation, nothing leaked or parked, and no cycle fell back
    off ``solver``. Returns the report and the host timings."""
    from kubernetes_tpu_torch.chaos import NetChaos
    from kubernetes_tpu_torch.sim import HollowCluster

    hub = HollowCluster(seed=seed, scheduler_kw={"device": device})
    nodes, _, pending = smoke_cell(n_nodes, 0, n_pods, seed)
    for nd in nodes:
        hub.add_node(nd)
    for p in pending:
        hub.create_pod(p)
    nc = NetChaos(hub, seed=seed,
                  scheduler_kw={"device": device, "solver": solver})
    real = nc.sched.schedule_cycle
    solve = SolveTimer(nc.sched)
    cycles, ends = [], []

    def timed(*a, **kw):
        solve.take()
        t0 = time.perf_counter()
        r = real(*a, **kw)
        _sync(device)
        t1 = time.perf_counter()
        cycles.append((r, t1 - t0, solve.take()))
        ends.append(t1)
        return r

    nc.sched.schedule_cycle = timed
    # the flight records' recovery counts, summed as each is recorded (a
    # run records more cycles than the recorder's ring holds)
    flagged = {"ambiguous_binds": 0, "invariant_violations": 0, "records": 0}
    record = nc.sched.obs.recorder.record

    def counted(rec):
        flagged["ambiguous_binds"] += rec.ambiguous_binds
        flagged["invariant_violations"] += rec.invariant_violations
        flagged["records"] += 1
        record(rec)

    nc.sched.obs.recorder.record = counted
    before = launch_counts()
    t0 = time.perf_counter()
    rep = nc.run(n_pods=0, n_nodes=0)
    wall = time.perf_counter() - t0
    launches = _launches_since(before)
    tag = f"recovery/A/{solver}/{device}/{n_nodes}"
    if not (rep["converged"] and rep["all_bound"]):
        fail(f"{tag}: did not converge: {rep}")
    if rep["double_bind_attempts"] or rep["invariant_violations"]:
        fail(f"{tag}: {rep['double_bind_attempts']} double-bind attempts, "
             f"violations {rep['violations']}")
    if rep["leaked_assumptions"] or rep["parked_ambiguous"]:
        fail(f"{tag}: leaked {rep['leaked_assumptions'][:3]}, parked "
             f"{rep['parked_ambiguous'][:3]}")
    if rep["bound_total"] != n_pods:
        fail(f"{tag}: the hub bound {rep['bound_total']} of {n_pods}")
    if (flagged["ambiguous_binds"] != rep["ambiguous_timeouts"]
            or flagged["invariant_violations"]
            != rep["invariant_violations"]):
        fail(f"{tag}: the flight records flag {flagged}, the harness "
             f"counted {rep['ambiguous_timeouts']} ambiguous timeouts and "
             f"{rep['invariant_violations']} violations")
    for r, _, _ in cycles:
        if r.solver_tier not in ("", solver) or r.solver_fallbacks:
            fail(f"{tag}: a cycle solved on {r.solver_tier!r} after "
                 f"{r.solver_fallbacks} fallbacks")
    steps = [b - a for a, b in zip([t0] + ends[:-1], ends)]
    cyc = [s for _, s, _ in cycles if s > 0]
    return {"report": rep, "wall_s": wall, "steps": rep["steps"],
            "launches": launches,
            "step_s_p50": _pct(steps, 50), "step_s_max": max(steps),
            "cycle_s_sum": sum(cyc), "cycle_s_p50": _pct(cyc, 50),
            "cycle_s_max": max(cyc),
            "solve_s_sum": sum(sp for _, _, sp in cycles),
            "records_flagged": flagged,
            "attempted": [r.attempted for r, _, _ in cycles][:16],
            "snapshot_modes": sorted({r.snapshot_mode for r, _, _ in cycles
                                      if r.snapshot_mode})}


def recovery_arm_a() -> dict:
    """Arm A, cell ``netchaos-5k``: ``NetChaos`` on the card at full width
    with the default solver (the pair on every general round) and with
    ``solver: sinkhorn`` (u and v every plan round); then the reduced
    shape on the card and on CPU tensors, whose reports must be equal
    field by field, for each solver."""
    out = {}
    for solver in ("batch", "sinkhorn"):
        got = netchaos_run("cuda", solver=solver, **NETCHAOS_FULL)
        rep = got.pop("report")
        out[solver] = {**got, **{k: rep[k] for k in (
            "bound_total", "binds_attempted", "ambiguous_timeouts",
            "timeouts_committed", "timeouts_uncommitted", "faults_fired",
            "watch_deduped", "relists", "stalled_relists",
            "invariant_violations", "double_bind_attempts")}}
        release_graphs()
    eq = {}
    for solver in ("batch", "sinkhorn"):
        a = netchaos_run("cuda", solver=solver, **NETCHAOS_REDUCED)
        b = netchaos_run("cpu", solver=solver, **NETCHAOS_REDUCED)
        if a["report"] != b["report"]:
            diff = {k: (a["report"][k], b["report"].get(k))
                    for k in a["report"] if a["report"][k] != b["report"][k]}
            fail(f"recovery/A/{solver}: the card's report differs from the "
                 f"CPU's at {NETCHAOS_REDUCED}: {diff}")
        eq[solver] = {"equal": True, "steps": a["steps"],
                      "cuda_wall_s": a["wall_s"], "cpu_wall_s": b["wall_s"],
                      "cuda_launches": a["launches"]}
        release_graphs()
    cycles = (sum(v["steps"] for v in out.values())
              + sum(v["steps"] for v in eq.values()))
    return {"full": out, "equality": {**NETCHAOS_REDUCED, **eq},
            "cycles": cycles}


class _AllocatorProbe:
    """Wraps a cache's ``drop_device_snapshot``: the caching allocator's
    allocated and reserved bytes just before and just after each drop."""

    def __init__(self, cache) -> None:
        import torch

        self.rows = []
        real = cache.drop_device_snapshot

        def drop():
            before = (torch.cuda.memory_allocated(),
                      torch.cuda.memory_reserved())
            real()
            self.rows.append({
                "allocated_before": before[0], "reserved_before": before[1],
                "allocated_after": torch.cuda.memory_allocated(),
                "reserved_after": torch.cuda.memory_reserved()})

        cache.drop_device_snapshot = drop


def _devloss_scheduler(tmp, name, pods, inj=None, resident=True,
                       warm=True):
    """A ``Scheduler.from_config`` of arm B's JSON document (recovery
    {deviceResetLimit: 2, deviceCooloff: 30s}, warmup on, every node
    scored) on a hand-advanced clock, fed the smoke cluster, warmed with
    the first 64 pods as ``cli.run``'s gate does. Its binder confirms
    each bind at once (the watch's MODIFIED event)."""
    import torch

    from kubernetes_tpu_torch.ops import device_loop

    doc = {"recovery": {"deviceResetLimit": 2, "deviceCooloff": "30s"},
           "warmup": {"enabled": True}, "percentageOfNodesToScore": 100}
    if not resident:
        doc["deviceResidentSnapshot"] = False
    clk = _Clock()
    sched = configured(doc, tmp, name, clock=clk, fault_injector=inj)
    sched.binder = ConfirmingBinder(sched)
    nodes, bound, _ = smoke_cell(DEVLOSS["n_nodes"], DEVLOSS["n_bound"], 0)
    feed(sched, nodes, bound, [])
    c0 = device_loop.CAPTURES.count
    warmed = sched.warmup(sample_pods=pods[:64]) if warm else 0
    torch.cuda.synchronize()
    return sched, clk, {"warmed": warmed,
                        "warm_captures": device_loop.CAPTURES.count - c0}


def _devloss_cycle(sched, clk, pods, k, tag):
    """Cycle ``k``: the batch's pods in, one cycle under
    ``torch.cuda.set_sync_debug_mode("error")`` (an uncounted sync
    raises), the clock one second on."""
    import torch

    for p in pods[k * DEVLOSS["batch"]:(k + 1) * DEVLOSS["batch"]]:
        sched.on_pod_add(p)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        r = sched.schedule_cycle()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if r.solver_fallbacks or r.solver_tier != "batch":
        fail(f"{tag}: cycle {k + 1} solved on {r.solver_tier!r} after "
             f"{r.solver_fallbacks} fallbacks")
    clk.t += 1.0
    return r, wall


#: arm B's fault script: cycle -> (faults armed at ``snapshot:device``
#: before it, seconds the clock jumps before it, its expected snapshot
#: mode, whether the scheduler is degraded after it)
DEVLOSS_SCRIPT = ((0, 0.0, ("full", "clean", "delta"), False),
                  (1, 0.0, ("full",), False),
                  (3, 0.0, ("host",), True),
                  (0, 0.0, ("host",), True),
                  (0, 0.0, ("host",), True),
                  (0, 31.0, ("full",), False))


def recovery_arm_b(tmp: str) -> dict:
    """Arm B, cell ``devloss-5k``: a fault-free twin's placements over six
    cycles of 1024 zone-preferring pods, then for ``device_lost`` and for
    ``device_oom`` a scheduler whose ``snapshot:device`` seam fails as
    ``DEVLOSS_SCRIPT`` says (one reset and a rebuild; the budget blown and
    host mode; two cycles inside the 30 s cooloff; resident again after
    it), a scheduler with ``deviceResidentSnapshot: false``, and one whose
    warmup loses the device. Every cycle must place as the twin's, reset
    exactly as often as faults were injected, capture no graph after a
    complete warmup and run clean under sync-debug ``error``. Reports the
    allocator's bytes around each drop, and around a drop and rebuild of
    the resident table by hand."""
    import gc

    import torch

    from kubernetes_tpu_torch.cache import tree_nbytes
    from kubernetes_tpu_torch.faults import FaultInjector
    from kubernetes_tpu_torch.scheduler import RECOVERY

    n = DEVLOSS["batch"] * DEVLOSS["cycles"]
    _, _, pods = smoke_cell(DEVLOSS["n_nodes"], 0, n, seed=11)
    out = {}
    before = launch_counts()
    twin, clk, warm = _devloss_scheduler(tmp, "twin", pods)
    want = []
    for k in range(DEVLOSS["cycles"]):
        r, _ = _devloss_cycle(twin, clk, pods, k, "recovery/B/twin")
        if r.scheduled != DEVLOSS["batch"]:
            fail(f"recovery/B/twin: cycle {k + 1} bound {r.scheduled}")
        want.append(dict(r.assignments))
    out["twin"] = warm
    del twin
    for kind in ("device_lost", "device_oom"):
        inj = FaultInjector(seed=7)
        sched, clk, warm = _devloss_scheduler(tmp, kind, pods, inj)
        probe = _AllocatorProbe(sched.cache)
        rows, injected = [], 0
        RECOVERY.reset()
        for k, (shots, jump, modes, degraded) in enumerate(DEVLOSS_SCRIPT):
            if shots:
                inj.arm("snapshot:device", kind, count=shots)
                injected += shots
            clk.t += jump
            r, wall = _devloss_cycle(sched, clk, pods, k,
                                     f"recovery/B/{kind}")
            resets = sched.metrics.recovery_device_resets.value()
            row = {"cycle": k + 1, "mode": r.snapshot_mode,
                   "degraded": sched.is_degraded(), "resets": resets,
                   "graph_captures": r.graph_captures,
                   "host_syncs": r.host_syncs, "cycle_s": wall}
            rows.append(row)
            if r.assignments != want[k]:
                bad = sum(r.assignments.get(p) != v
                          for p, v in want[k].items())
                fail(f"recovery/B/{kind}: cycle {k + 1} placed {bad} pods "
                     "unlike the fault-free twin")
            if r.snapshot_mode not in modes or row["degraded"] != degraded:
                fail(f"recovery/B/{kind}: cycle {k + 1}: {row}, expected "
                     f"mode in {modes}, degraded {degraded}")
            if resets != injected or r.graph_captures:
                fail(f"recovery/B/{kind}: cycle {k + 1}: {resets} resets for "
                     f"{injected} injected faults, {r.graph_captures} "
                     "graphs captured after warmup")
        if RECOVERY.device_resets != injected or RECOVERY.host_cycles != 3:
            fail(f"recovery/B/{kind}: process tally "
                 f"{RECOVERY.device_resets} resets, {RECOVERY.host_cycles} "
                 "host-mode cycles")
        # the flight records carry every reset with the memory ledger's
        # forensic flag (oom@<site> top=<name>:<bytes>B)
        flags = [(rec.device_resets, rec.oom_forensic)
                 for rec in sched.obs.recorder.records()]
        if (sum(n for n, _ in flags) != injected or any(
                (n > 0) != f.startswith("oom@snapshot:device")
                for n, f in flags)):
            fail(f"recovery/B/{kind}: flight records {flags} for {injected} "
                 "injected faults")
        # one oom incident bundle (the rest inside its cooldown), and the
        # forensic ring on /debug/memory, its top resident the node table
        bundles = [b["trigger"] for b in sched.obs.incidents.incidents()]
        status, memory = debug_get(sched, "/debug/memory")
        ooms = memory.get("oom_records", [])
        if status != 200 or bundles != ["oom"] or len(ooms) != injected or \
                ooms[0]["top_residents"][0]["name"] != "cache.node_table":
            fail(f"recovery/B/{kind}: bundles {bundles}, {len(ooms)} "
                 f"forensic records for {injected} faults, top residents "
                 f"{ooms[0]['top_residents'] if ooms else None}")
        out[kind] = {**warm, "cycles": rows, "injected": injected,
                     "drops": list(probe.rows), "records": flags,
                     "incident_bundles": bundles,
                     "forensic_top_residents": ooms[0]["top_residents"]}
        if kind == "device_lost":
            # a drop and a rebuild by hand: what the allocator does
            gc.collect()
            torch.cuda.synchronize()
            table = tree_nbytes(sched.cache._dev)
            a0, r0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
            sched.cache.drop_device_snapshot()
            gc.collect()
            a1, r1 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
            sched.cache.device_snapshot()
            torch.cuda.synchronize()
            a2, r2 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
            out["allocator"] = {
                "table_bytes": table, "allocated": [a0, a1, a2],
                "reserved": [r0, r1, r2],
                "drop_freed_allocated": a0 - a1,
                "drop_freed_reserved": r0 - r1,
                "rebuild_reused_reserved": r2 == r1}
        del sched, probe
    # host mode all along: deviceResidentSnapshot false
    sched, clk, warm = _devloss_scheduler(tmp, "host", pods, resident=False)
    modes, caps = [], 0
    for k in range(DEVLOSS["cycles"]):
        r, _ = _devloss_cycle(sched, clk, pods, k, "recovery/B/host")
        if r.assignments != want[k]:
            fail(f"recovery/B/host: cycle {k + 1} placed unlike the "
                 "resident twin")
        modes.append(r.snapshot_mode)
        caps += r.graph_captures
    if set(modes) != {"host"} or caps or sched.cache.has_device_snapshot():
        fail(f"recovery/B/host: modes {modes}, {caps} captures, resident "
             f"table {sched.cache.has_device_snapshot()}")
    out["host_mode"] = {**warm, "modes": modes, "graph_captures": caps}
    del sched
    # the warmup loses the device: it aborts, the next cycle places right
    inj = FaultInjector(seed=7).arm("warmup:compile", "device_lost", count=1)
    sched, clk, warm = _devloss_scheduler(tmp, "warmup", pods, inj)
    resets = sched.metrics.recovery_device_resets.value()
    if warm["warmed"] != 0 or resets != 1 or \
            sched.cache.has_device_snapshot():
        fail(f"recovery/B/warmup: warmed {warm['warmed']} shapes, {resets} "
             "resets, resident table kept")
    r, _ = _devloss_cycle(sched, clk, pods, 0, "recovery/B/warmup")
    if r.assignments != want[0] or r.snapshot_mode != "full":
        fail("recovery/B/warmup: the cycle after the aborted warmup placed "
             f"unlike the twin ({r.snapshot_mode})")
    # the warmup's loss came between cycles: its flag parks for the next
    # cycle's flight record
    parked = sched.obs.recorder.records()[-1].oom_forensic
    if not parked.startswith("oom@warmup:compile"):
        fail(f"recovery/B/warmup: the next record's forensic flag is "
             f"{parked!r}")
    out["warmup_abort"] = {**warm, "resets": resets,
                           "next_cycle_mode": r.snapshot_mode,
                           "next_cycle_captures": r.graph_captures,
                           "next_record_forensic": parked}
    del sched
    out["launches"] = _launches_since(before)
    return out


def recovery_arm_c() -> dict:
    """Arm C, cell ``ha-5k``: two ``chaos.HAReplica`` on one
    ``sim.HollowCluster`` of the smoke cell's 5000 nodes, the reference
    failover test's lease (15 s / 10 s / 2 s). Pods of the smoke cell's
    shape are created in ``HA["batches"]`` batches, one per 2 s tick; the
    leader is ``kill()``ed after half of them, mid-churn. Fails unless
    the standby takes over and every pod is bound exactly once (the
    hub's CAS saw no conflict), and the standby leaks no assumption.
    Reports the takeover seconds on the hub's clock (the kill to the
    standby's first bind) and the host seconds of the takeover tick."""
    from kubernetes_tpu_torch.chaos import HAReplica
    from kubernetes_tpu_torch.config import LeaderElectionConfig
    from kubernetes_tpu_torch.sim import HollowCluster

    hub = HollowCluster(seed=7, scheduler_kw={"device": "cuda"})
    nodes, _, pending = smoke_cell(HA["n_nodes"], 0, HA["n_pods"], seed=13)
    for nd in nodes:
        hub.add_node(nd)
    le = LeaderElectionConfig(**HA_LEASE)
    launches0 = launch_counts()
    t0 = time.perf_counter()
    a, b = HAReplica("a", hub, le), HAReplica("b", hub, le)
    build_s = time.perf_counter() - t0
    per = HA["n_pods"] // HA["batches"]
    kill_at, takeover, tick_s = None, None, []
    bound_at_kill = 0
    for tick in range(HA["batches"] + 40):
        if tick < HA["batches"]:
            for p in pending[tick * per:(tick + 1) * per]:
                hub.create_pod(p)
        if tick == HA["batches"] // 2:
            a.kill()
            kill_at = hub.clock()
            bound_at_kill = hub.bound_total
        before = hub.bound_total
        t1 = time.perf_counter()
        a.tick()
        b.tick()
        wall = time.perf_counter() - t1
        tick_s.append(wall)
        if (kill_at is not None and takeover is None
                and hub.bound_total > before):
            takeover = {"sim_s": hub.clock() - kill_at,
                        "tick_wall_s": wall, "tick": tick}
        if tick >= HA["batches"] and hub.bound_total == HA["n_pods"]:
            break
        hub.clock.advance(2.0)
    # settle: the standby's informer confirms its own last binds
    hub.clock.advance(31.0)
    b.tick()
    b.sched.idle_tick()
    unbound = [k for k, p in hub.truth_pods.items() if not p.node_name]
    if unbound or hub.bound_total != HA["n_pods"]:
        fail(f"recovery/C: {len(unbound)} pods unbound, the hub bound "
             f"{hub.bound_total} of {HA['n_pods']}")
    if hub.binder.conflicts:
        fail(f"recovery/C: {hub.binder.conflicts} binds refused by the "
             "hub's CAS (a second bind of a bound pod)")
    if not b.elector.is_leader() or takeover is None:
        fail("recovery/C: the standby never took over")
    if b.sched.cache.assumed_keys():
        fail(f"recovery/C: the standby leaks "
             f"{len(b.sched.cache.assumed_keys())} assumptions")
    hub.check_consistency()
    return {"build_s": build_s, "ticks": len(tick_s),
            "tick_s_p50": _pct(tick_s, 50), "tick_s_max": max(tick_s),
            "bound_at_kill": bound_at_kill, "takeover": takeover,
            "leader_cycles": a.cycles, "standby_cycles": b.cycles,
            "takeovers": b.sched.metrics.recovery_takeovers.value(),
            "adopted": b.sched.metrics.recovery_adopted.value(),
            "bound_total": hub.bound_total,
            "conflicts": hub.binder.conflicts,
            "dead_leader_torn_assumptions": len(a.sched.cache.assumed_keys()),
            "launches": _launches_since(launches0)}


def phase_recovery() -> dict:
    """The recovery paths: arm A (``netchaos-5k``), arm B (``devloss-5k``)
    and arm C (``ha-5k``), each counted from 0 together. Returns their
    launches, cycles and launch shapes; fails unless the pair, u and v
    each launched."""
    import tempfile

    from kubernetes_tpu_torch import kernels

    kernels.reset_launches()
    t0 = time.perf_counter()
    a = recovery_arm_a()
    emit({"phase": "recovery", "arm": "A", "cell": "netchaos-5k",
          "wall_s": time.perf_counter() - t0, **a})
    release_graphs()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ktt-recovery-") as tmp:
        b = recovery_arm_b(tmp)
    emit({"phase": "recovery", "arm": "B", "cell": "devloss-5k",
          "wall_s": time.perf_counter() - t0, **b})
    release_graphs()
    t0 = time.perf_counter()
    c = recovery_arm_c()
    emit({"phase": "recovery", "arm": "C", "cell": "ha-5k",
          "wall_s": time.perf_counter() - t0, **c})
    launches, shapes = launch_counts(), launch_shapes()
    for name in ARRAY_KERNELS:
        if launches[name] <= 0:
            fail(f"recovery: {name} was never launched")
    # arm B: the twin, the two fault kinds and host mode, six cycles
    # each, and the cycle after the aborted warmup
    cycles = (a["cycles"] + 4 * DEVLOSS["cycles"] + 1 + c["leader_cycles"]
              + c["standby_cycles"])
    return {"launches": launches, "cycles": cycles, "shapes": shapes}


# ---------------------------------------------------------------------------
# phase 15: the device backends of observability (cell ledger-5k)
# ---------------------------------------------------------------------------

#: cell ``ledger-5k``: the smoke cell's cluster (5000 nodes over 10 zones,
#: 1000 bound, every 10th node PreferNoSchedule; pending pods 100m / 500 Mi
#: preferring a seeded zone), monolithic cycles (``pipelineDepth: 1``, so
#: the preflight may split), warmup at pod buckets 1024-8192 (N = 8192).
#: Arm A's cycles: four at the largest bucket, then one at each smaller
#: bucket, each bucket's live peak held against its captured bytes. Arm
#: C: healthy cycles of 64 pods, then bursts of 8192, then 64-pod cycles
#: until the fast window clears (at most ``c_recover_s``)
LEDGER = {"n_nodes": 5000, "n_bound": 1000,
          "buckets": (1024, 2048, 4096, 8192),
          "a_batches": (8192, 8192, 8192, 8192, 4096, 2048, 1024),
          "c_small": 64, "c_healthy": 6, "c_burst": 8192, "c_bursts": 4,
          "c_recover_s": 12.0}

#: the reference's top-level keys of each route's JSON body
#: (kubernetes_tpu/obs/ledger.py snapshot, memledger.py snapshot,
#: incidents.py snapshot, server.py profile_payload)
LEDGER_ROUTE_KEYS = {
    "/debug/ledger": {"observed", "retained", "model", "slo",
                      "model_efficiency", "distributions", "entries"},
    "/debug/memory": {"enabled", "observed", "samples", "modeled_bytes",
                      "measured_bytes", "peak_bytes", "census", "devices",
                      "residents", "buckets", "preflight", "watermarks",
                      "entries", "oom_records", "limit_bytes",
                      "model_efficiency"},
    "/debug/incidents": {"enabled", "capacity", "total", "by_trigger",
                         "profiles_taken", "profile_active",
                         "profile_errors", "incidents"},
    "/debug/profile?cycles=2": {"started", "cycles", "profile_dir",
                                "profiles_taken", "note"},
}

#: the backends' per-cycle host work: the perf ledger's fold, the memory
#: ledger's sample, preflight and registration, the incident triggers
BACKEND_CALLS = (("ledger", "observe_cycle"), ("memledger", "observe_cycle"),
                 ("memledger", "preflight"), ("memledger", "register_tree"),
                 ("incidents", "observe_cycle"))


def _ledger_n() -> int:
    """The cell's padded node count (8192 at 5000 nodes)."""
    from kubernetes_tpu_torch.utils.interner import bucket_size

    return bucket_size(LEDGER["n_nodes"])


def _ledger_doc(buckets=None, **observability) -> dict:
    doc = {"percentageOfNodesToScore": 100, "pipelineDepth": 1,
           "warmup": {"enabled": True,
                      "podBuckets": list(buckets or LEDGER["buckets"])}}
    if observability:
        doc["observability"] = observability
    return doc


def _ledger_scheduler(tmp, name, nodes, bound, sample, buckets=None, kw=None,
                      **observability):
    """``Scheduler.from_config`` of the cell's document on the card, fed
    the cluster and warmed with ``sample`` as ``cli.run``'s gate does.
    Returns the scheduler and its warmup's summary."""
    import torch

    from kubernetes_tpu_torch.ops import device_loop

    release_graphs()
    sched = configured(_ledger_doc(buckets, **observability), tmp, name,
                       **(kw or {}))
    feed(sched, nodes, bound, [])
    c0 = device_loop.CAPTURES.count
    t0 = time.perf_counter()
    warmed = sched.warmup(sample_pods=sample)
    torch.cuda.synchronize()
    return sched, {"warmed": warmed, "warmup_s": time.perf_counter() - t0,
                   "warm_captures": device_loop.CAPTURES.count - c0}


def _ledger_cycle(sched, pods, timer=None, live_peak=False) -> dict:
    """Pods in, one cycle, the card synchronised; with ``live_peak`` the
    allocator's peak over the cycle's start (reset just before it)."""
    import torch

    for p in pods:
        sched.on_pod_add(p)
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    if live_peak:
        torch.cuda.reset_peak_memory_stats()
    if timer is not None:
        timer.take()
    n_rec = sched.obs.recorder.recorded
    t0 = time.perf_counter()
    r = sched.schedule_cycle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = (sched.obs.recorder.records()[-1]
           if sched.obs.recorder.recorded > n_rec else None)
    return {"r": r, "wall": wall, "rec": rec,
            "spans": sched.obs.last_trace.span_durations(),
            "backend_s": timer.take() if timer is not None else None,
            "live_peak": (torch.cuda.max_memory_allocated() - start
                          if live_peak else None)}


def _tier_ok(tag, rows) -> None:
    for k, row in enumerate(rows):
        r = row["r"]
        if r.attempted and (r.solver_tier != "batch" or r.solver_fallbacks):
            fail(f"{tag}: cycle {k + 1} solved on {r.solver_tier!r} after "
                 f"{r.solver_fallbacks} fallbacks")


def ledger_arm_a(tmp, nodes, bound, pods) -> dict:
    """Arm A, the backends at their defaults against a twin with all three
    off: equal placements and host syncs, no graph captured after warmup,
    the cost model's verdict on every cycle from the second, one memory
    ledger entry a cycle from the allocator with preflight ``ok``, and
    each warmed bucket's captured bytes against a live cycle's peak at
    that bucket."""
    import torch

    batches = LEDGER["a_batches"]
    runs = {}
    for arm, obs in (("defaults", {}),
                     ("backends-off", {"ledger": {"enabled": False},
                                       "memoryLedger": {"enabled": False},
                                       "incidents": {"enabled": False}})):
        sched, warm = _ledger_scheduler(tmp, f"ledger-a-{arm}", nodes, bound,
                                        pods[:64], **obs)
        timer = (HostTimer((getattr(sched.obs, attr), name)
                           for attr, name in BACKEND_CALLS)
                 if arm == "defaults" else None)
        rows, i = [], 0
        for n in batches:
            rows.append(_ledger_cycle(sched, pods[i:i + n], timer,
                                      live_peak=arm == "defaults"))
            i += n
        _tier_ok(f"ledger/A/{arm}", rows)
        if warm["warmed"] <= 0 or warm["warm_captures"] <= 0:
            fail(f"ledger/A/{arm}: warmup {warm}")
        caps = [row["r"].graph_captures for row in rows]
        if any(caps):
            fail(f"ledger/A/{arm}: graphs captured after warmup: {caps}")
        if [row["r"].attempted for row in rows] != list(batches):
            fail(f"ledger/A/{arm}: cycles attempted "
                 f"{[row['r'].attempted for row in rows]}")
        runs[arm] = (sched, warm, rows)
        if arm == "defaults":
            ml = sched.obs.memledger
            table = {P: dict(e) for (P, N, m), e in
                     sorted(ml.bucket_table().items()) if N == _ledger_n()}
            snap = ml.snapshot()
            ledger_snap = sched.obs.ledger.snapshot()
            eff_gauge = sched.metrics.cycle_model_efficiency.value()
            total_memory = torch.cuda.get_device_properties(0).total_memory
        del sched
    on, off = runs["defaults"][2], runs["backends-off"][2]
    for k, (a, b) in enumerate(zip(on, off)):
        if a["r"].assignments != b["r"].assignments:
            fail(f"ledger/A: cycle {k + 1} placed unlike the backends-off "
                 "twin")
        if a["r"].host_syncs != b["r"].host_syncs:
            fail(f"ledger/A: cycle {k + 1}: {a['r'].host_syncs} host syncs, "
                 f"{b['r'].host_syncs} with the backends off")
    # the perf ledger's verdict, from the second cycle on
    for k, row in enumerate(on[1:], start=2):
        rec, r = row["rec"], row["r"]
        if not (0 < r.model_efficiency <= 8 and rec is not None
                and rec.model_basis and rec.model_efficiency
                == r.model_efficiency):
            fail(f"ledger/A: cycle {k}: efficiency {r.model_efficiency}, "
                 f"basis {rec.model_basis if rec else None!r}")
    if not 0 < eff_gauge <= 8:
        fail(f"ledger/A: scheduler_cycle_model_efficiency {eff_gauge}")
    # the memory ledger: one entry a cycle, the allocator's counters
    entries = snap["entries"]
    if len(entries) != len(on) or any(e["preflight"] != "ok"
                                      for e in entries):
        fail(f"ledger/A: memory entries {entries}")
    if set(snap["devices"]) != {"0"} or \
            snap["devices"]["0"]["limit"] != total_memory:
        fail(f"ledger/A: measured side {snap['devices']} (limit "
             f"{total_memory})")
    sampled = [e for e in entries if e["measured_bytes"] >= 0]
    if not sampled or any(e["measured_bytes"] <= e["modeled_bytes"]
                          for e in sampled):
        fail(f"ledger/A: allocator samples {sampled}")
    # each warmed bucket against a live cycle's peak at that bucket
    if sorted(table) != sorted(LEDGER["buckets"]):
        fail(f"ledger/A: bucket table {sorted(table)}")
    live = {}
    for n, row in zip(batches, on):
        live.setdefault(n, row["live_peak"])
    peaks = {P: {"captured_total_bytes": table[P]["total_bytes"],
                 "captured": table[P], "live_cycle_peak_bytes": live[P],
                 "captured_over_live": table[P]["total_bytes"] / live[P]}
             for P in table}
    for P, row in peaks.items():
        if row["captured_total_bytes"] < 0.9 * row["live_cycle_peak_bytes"]:
            fail(f"ledger/A: bucket {P} captured {row['captured_total_bytes']}"
                 f" bytes, under 90% of a live cycle's peak "
                 f"{row['live_cycle_peak_bytes']}")
    # the backends' host cost on the warm cycles at the largest bucket
    warm = range(1, 4)
    on_s = [on[k]["wall"] for k in warm]
    off_s = [off[k]["wall"] for k in warm]
    backend_s = [on[k]["backend_s"] for k in warm]
    return {
        "warmup": {arm: runs[arm][1] for arm in runs},
        "bucket_peaks": peaks,
        "cycle_s_defaults": [row["wall"] for row in on],
        "cycle_s_backends_off": [row["wall"] for row in off],
        "host_syncs": [row["r"].host_syncs for row in on],
        "model_efficiency": [row["r"].model_efficiency for row in on],
        "model_basis": [row["rec"].model_basis if row["rec"] else ""
                        for row in on],
        "modeled_s": [row["r"].modeled_s for row in on],
        "solve_s": [row["r"].solve_s for row in on],
        "anchors": ledger_snap["model"]["anchors"],
        "signatures": ledger_snap["model"]["signatures"],
        "memory_entries": entries,
        "backend_s_warm": backend_s,
        "backend_share_of_warm_cycle_pct": [
            100.0 * b / w for b, w in zip(backend_s, on_s)],
        "warm_cycle_s_delta_pct": 100.0 * (statistics.median(on_s)
                                           - statistics.median(off_s))
        / statistics.median(off_s),
        "cycles": 2 * len(on), "table": table}


def ledger_arm_b(tmp, nodes, bound, pods, table) -> dict:
    """Arm B, the capacity preflight: ``memoryLedger.limitBytes`` from
    arm A's table, so that limit x 0.9 lies between the 4096 and 8192
    buckets. An 8192 batch splits to 4096 and places as a twin whose batch
    is capped at 4096; every pod binds over the next cycles; then a limit
    under the smallest bucket sheds every cycle, binding nothing and
    keeping every pod queued; the verdict counter equals the verdicts."""
    top, half, shed_n = (LEDGER["buckets"][-1], LEDGER["buckets"][-2],
                         LEDGER["buckets"][1])
    big, small = table[top]["total_bytes"], table[half]["total_bytes"]
    limit = int((big + small) / 2 / 0.9)
    sched, warm = _ledger_scheduler(tmp, "ledger-b", nodes, bound, pods[:64],
                                    memoryLedger={"limitBytes": limit})
    ml = sched.obs.memledger
    tb = {P: e["total_bytes"] for (P, N, m), e in ml.bucket_table().items()
          if N == _ledger_n()}
    budget = ml.limit_bytes() * ml.config.headroom_frac
    if not tb.get(half, budget + 1) <= budget < tb.get(top, 0):
        fail(f"ledger/B: the budget {budget} does not lie between this "
             f"scheduler's {half} and {top} buckets {tb}")
    twin = configured(_ledger_doc(memoryLedger={"enabled": False}), tmp,
                      "ledger-b-twin", max_batch=half)
    feed(twin, nodes, bound, [])
    verdicts = {"ok": 0, "split": 0, "shed": 0}
    split = _ledger_cycle(sched, pods[:top])
    want = _ledger_cycle(twin, pods[:top])
    del twin
    verdicts["split"] += 1
    r = split["r"]
    if r.attempted != half or split["rec"].preflight != "split":
        fail(f"ledger/B: the {top} batch attempted {r.attempted} "
             f"(preflight {split['rec'].preflight!r})")
    if r.assignments != want["r"].assignments:
        n = sum(r.assignments.get(k) != v
                for k, v in want["r"].assignments.items())
        fail(f"ledger/B: the split cycle placed {n} pods unlike the twin "
             f"capped at {half}")
    rows = [split]
    bound_total = r.scheduled
    for _ in range(4):
        if sum(sched.queue.pending_counts().values()) == 0:
            break
        rows.append(_ledger_cycle(sched, []))
        verdicts["ok"] += 1
        bound_total += rows[-1]["r"].scheduled
    _tier_ok("ledger/B", rows)
    if bound_total != top or any(row["r"].graph_captures for row in rows):
        fail(f"ledger/B: bound {bound_total} of {top}, captures "
             f"{[row['r'].graph_captures for row in rows]}")
    # a limit under the smallest bucket: every cycle sheds
    ml.config.limit_bytes = int(min(tb.values()) * ml.config.headroom_frac
                                / 2)
    shed = []
    for k in range(2):
        shed.append(_ledger_cycle(
            sched, pods[top:top + shed_n] if k == 0 else []))
        verdicts["shed"] += 1
    queued = sum(sched.queue.pending_counts().values())
    if any(row["r"].attempted or row["r"].scheduled for row in shed) or \
            queued != shed_n:
        fail(f"ledger/B: shed cycles attempted "
             f"{[row['r'].attempted for row in shed]}, {queued} queued")
    counted = {a: sched.metrics.memory_preflight.value(action=a)
               for a in verdicts}
    if counted != verdicts or dict(ml.preflights) != verdicts:
        fail(f"ledger/B: preflight counter {counted}, ledger "
             f"{ml.preflights}, verdicts {verdicts}")
    if ml.oom_records():
        fail(f"ledger/B: {len(ml.oom_records())} out-of-memory records")
    return {"warmup": warm, "limit_bytes": limit, "budget_bytes": budget,
            "buckets_total_bytes": tb,
            "split_cycle_s": split["wall"], "twin_4096_cycle_s": want["wall"],
            "split_cycle_spans_s": split["spans"],
            "twin_4096_cycle_spans_s": want["spans"],
            "cycle_s": [row["wall"] for row in rows],
            "attempted": [row["r"].attempted for row in rows],
            "shed_cycle_s": [row["wall"] for row in shed],
            "preflight_total": counted, "oom_records": 0,
            "cycles": len(rows) + len(shed) + 1}


def ledger_arm_c(tmp, nodes, bound, pods) -> dict:
    """Arm C, the SLO watchdog and the incidents: ``costDriftRatio: 2.0``
    over 2 s / 4 s windows, incidents profiling 2 cycles once. Healthy
    64-pod cycles set the baseline; bursts of 8192 pods (a backlog after a
    quiet spell: their solves cost more than twice the baseline by real
    work) burn it: ``slo`` on the record, a ``SchedulerSLOBurn`` event,
    the scheduler degraded (APF pressure x4), one ``slo-burn`` bundle and
    a ``torch.profiler`` trace naming the fused pair's kernel; 64-pod
    cycles until the fast window clears recover it. The four debug routes
    then answer over HTTP with the reference's keys."""
    small, n_burst = LEDGER["c_small"], LEDGER["c_burst"]
    prof_dir = os.path.join(tmp, "profiles")
    events = []
    sched, warm = _ledger_scheduler(
        tmp, "ledger-c", nodes, bound, pods[:64], buckets=(small, n_burst),
        kw={"event_sink": lambda reason, obj, msg: events.append(
            (reason, msg))},
        ledger={"costDriftRatio": 2.0, "fastWindow": "2s",
                "slowWindow": "4s"},
        incidents={"profileCycles": 2, "maxProfiles": 1,
                   "profileDir": prof_dir})
    i = 0

    def take(n):
        nonlocal i
        i += n
        return pods[i - n:i]

    rows = [_ledger_cycle(sched, take(small))
            for _ in range(LEDGER["c_healthy"])]
    baseline = dict(sched.obs.ledger.watchdog.snapshot()["cost_baseline_s"])
    burst = [_ledger_cycle(sched, take(n_burst))
             for _ in range(LEDGER["c_bursts"])]
    slo = [row["rec"].slo if row["rec"] else "" for row in burst]
    for p in take(small):
        sched.on_pod_add(p)
    depth = float(sched.queue.pending_counts().get("active", 0))
    degraded = sched.is_degraded()
    pressure = sched.backend_pressure(degraded_factor=4.0)
    inc = sched.obs.incidents
    burn_bundles = [b for b in inc.incidents() if b["trigger"] == "slo-burn"]
    if "cost_drift" not in slo:
        fail(f"ledger/C: the bursts' records say slo {slo} (baseline "
             f"{baseline}, burst solve s "
             f"{[row['r'].solve_s for row in burst]})")
    if not any(e[0] == "SchedulerSLOBurn" for e in events):
        fail(f"ledger/C: no SchedulerSLOBurn event in {events}")
    if not degraded or depth <= 0 or pressure != 4.0 * depth:
        fail(f"ledger/C: degraded {degraded}, pressure {pressure} at depth "
             f"{depth}")
    if len(burn_bundles) != 1:
        fail(f"ledger/C: {len(burn_bundles)} slo-burn bundles")
    # recovery: healthy cycles until the fast window clears
    t_end = time.perf_counter() + LEDGER["c_recover_s"]
    recover = []
    while time.perf_counter() < t_end:
        recover.append(_ledger_cycle(sched, take(small)))
        if any(e[0] == "SchedulerSLORecovered" for e in events) and \
                not sched.is_degraded():
            break
        time.sleep(0.2)
    if not any(e[0] == "SchedulerSLORecovered" for e in events) or \
            sched.is_degraded():
        fail(f"ledger/C: no recovery within {LEDGER['c_recover_s']} s: "
             f"{events}")
    _tier_ok("ledger/C", rows + burst + recover)
    # the incident's profiler capture: a trace of the card's kernels
    if inc.profile_errors or len(inc.profile_paths) != 1:
        fail(f"ledger/C: {inc.profile_errors} profiler errors, traces "
             f"{inc.profile_paths}")
    with open(inc.profile_paths[0]) as f:
        trace = json.load(f)
    kernels_seen = sorted({e["name"][:80] for e in trace["traceEvents"]
                           if e.get("cat") == "kernel"})
    pair = [k for k in kernels_seen if "fused_pair" in k]
    if not pair:
        fail(f"ledger/C: the incident's trace names no fused_pair_normalize"
             f" kernel among {kernels_seen[:20]}")
    # the four routes over HTTP
    routes = {}
    for path, keys in LEDGER_ROUTE_KEYS.items():
        status, doc = debug_get(sched, path)
        if status != (409 if "profile" in path else 200) or set(doc) != keys:
            fail(f"ledger/C: {path} answered {status} with keys "
                 f"{sorted(doc)}")
        routes[path] = status
    return {"warmup": warm, "baseline_s": baseline,
            "healthy_solve_s": [row["r"].solve_s for row in rows],
            "burst_solve_s": [row["r"].solve_s for row in burst],
            "burst_cycle_s": [row["wall"] for row in burst],
            "burst_slo": slo,
            "slo_events": [e[0] for e in events if e[0].startswith(
                "SchedulerSLO")],
            "degraded_pressure": pressure, "active_depth": depth,
            "bundles": [(b["trigger"], b["cycle"]) for b in inc.incidents()],
            "recovery_cycles": len(recover),
            "profile_trace": os.path.basename(
                os.path.dirname(inc.profile_paths[0])),
            "profile_errors": inc.profile_errors,
            "pair_kernels_in_trace": pair, "routes": routes,
            "cycles": len(rows) + len(burst) + len(recover)}


def phase_ledger() -> dict:
    """Cell ``ledger-5k``: arms A (the defaults against the backends off),
    B (the capacity preflight) and C (the SLO watchdog and the incidents),
    each scheduler from a JSON v1alpha1 file through
    ``Scheduler.from_config``, counted from 0 together. Returns their
    launches, cycles and launch shapes; fails unless the pair
    launched."""
    import tempfile

    from kubernetes_tpu_torch import kernels

    nodes, bound, _ = smoke_cell(LEDGER["n_nodes"], LEDGER["n_bound"], 0)
    # arm A's cycles, or arm C's (its bursts and up to 64 recovery cycles)
    n_pods = max(sum(LEDGER["a_batches"]),
                 LEDGER["c_small"] * (LEDGER["c_healthy"] + 65)
                 + LEDGER["c_burst"] * LEDGER["c_bursts"])
    pods = smoke_cell(LEDGER["n_nodes"], 0, n_pods, seed=17)[2]
    kernels.reset_launches()
    out = {}
    with tempfile.TemporaryDirectory(prefix="ktt-ledger-") as tmp:
        t0 = time.perf_counter()
        a = ledger_arm_a(tmp, nodes, bound, pods)
        table = a.pop("table")
        emit({"phase": "ledger", "arm": "A", "cell": "ledger-5k",
              "wall_s": time.perf_counter() - t0, **a})
        t0 = time.perf_counter()
        b = ledger_arm_b(tmp, nodes, bound, pods, table)
        emit({"phase": "ledger", "arm": "B", "cell": "ledger-5k",
              "wall_s": time.perf_counter() - t0, **b})
        t0 = time.perf_counter()
        c = ledger_arm_c(tmp, nodes, bound, pods)
        emit({"phase": "ledger", "arm": "C", "cell": "ledger-5k",
              "wall_s": time.perf_counter() - t0, **c})
    out["launches"], out["shapes"] = launch_counts(), launch_shapes()
    if out["launches"]["fused_pair_normalize"] <= 0:
        fail("ledger: fused_pair_normalize was never launched")
    out["cycles"] = a["cycles"] + b["cycles"] + c["cycles"]
    return out


# ---------------------------------------------------------------------------
# phase 16: the scenario packs
# ---------------------------------------------------------------------------

#: the phase's cells: arm A's consolidation cell (the smoke cell), arm B's
#: gangs (the reference bench's BASELINE config 4, ``bench.py:1217-1250``),
#: arm D's restricted steady cycles and re-pack sweeps, the warmed cells'
#: cycles and the CUDA/CPU equality shape
SCENARIO = {"n_nodes": 5000, "n_bound": 1000, "n_pending": 10000,
            "gangs": 1000, "gang_size": 32, "gang_max_batch": 8192,
            "restricted_cycles": 12, "restricted_gangs": 3,
            "restricted_gang_size": 4, "restricted_plain": 20,
            "repack_interval_s": 30.0, "repack_max_pods": 64,
            "repack_sweeps": 3, "warm_bucket": 256, "warm_pods": 200,
            "eq_nodes": 500, "eq_pods": 1024, "preempt_ordinary": 4064,
            "restricted_burst": 1024}

#: the quality vector's fractions, CUDA against CPU (the unit test's
#: tolerance, tests/test_torch_scenario_cost.py)
QUALITY_RTOL, QUALITY_ATOL = 1e-5, 1e-6
QUALITY_COUNTS = ("nodes_used", "nodes_used_batch", "placed")
QUALITY_FRACTIONS = ("headroom", "fragmentation", "priority_headroom",
                     "free_cpu_frac")


def _scenario_doc(pack: str = "", **kw) -> dict:
    """The v1alpha1 document of a scenario arm: ``scenario: {pack, ...}``
    (no block for a stock twin) with ``percentageOfNodesToScore: 100``
    (the v1alpha1 default 0 truncates the node search) and the given
    top-level fields (``scenario_`` prefixed keys go into the block)."""
    doc = {"percentageOfNodesToScore": 100}
    sc = {k[len("scenario_"):]: v for k, v in kw.items()
          if k.startswith("scenario_")}
    doc.update({k: v for k, v in kw.items() if not k.startswith("scenario_")})
    if pack:
        doc["scenario"] = {"pack": pack, **sc}
    return doc


def _host_locality(groups: dict, zone_of: dict, superpod: int = 4) -> float:
    """Mean over placed gangs of the mean pairwise hop saving against
    cross-fabric (0 same zone, 1 same superpod, 2 fabric), from the node
    names' zones: the host's own count, independent of the port."""
    import itertools

    per = []
    for nodes in groups.values():
        if len(nodes) < 2:
            continue
        zs = [int(zone_of[n].rsplit("-", 1)[1]) if zone_of.get(n) else -1
              for n in nodes]
        saves = []
        for a, b in itertools.combinations(zs, 2):
            if a >= 0 and b >= 0 and a == b:
                saves.append(2)
            elif a >= 0 and b >= 0 and a // superpod == b // superpod:
                saves.append(1)
            else:
                saves.append(0)
        per.append(sum(saves) / len(saves))
    return sum(per) / len(per) if per else 0.0


#: the pack's host work, timed apart: the cost term (the gang pack's
#: home-slice greedy inside it), the host scores after the quality read
PACK_HOST = ("cost", "quality_host")
#: the scenario spans of a cycle's trace
SCENARIO_SPANS = ("scenario:cost", "pipeline:readback@quality")


def _scenario_run(sched, pods, max_cycles=16):
    """Feed ``pods`` and run cycles until the queue drains (at most
    ``max_cycles``); the card synchronised around each. Returns
    ``[(result, wall seconds)]``; each result also carries, as
    ``scenario_host``, its scenario spans' seconds and the pack's host
    methods' (``PACK_HOST``, on ``perf_counter``)."""
    import torch

    timer = (HostTimer((sched.scenario_pack, m) for m in PACK_HOST)
             if sched.scenario_pack is not None else None)
    for p in pods:
        sched.on_pod_add(p)
    out = []
    for _ in range(max_cycles):
        torch.cuda.synchronize()
        if timer is not None:
            timer.take()
        t0 = time.perf_counter()
        r = sched.schedule_cycle()
        torch.cuda.synchronize()
        if r.attempted == 0:
            break
        spans = sched.obs.last_trace.span_durations()
        r.scenario_host = {**{k: spans.get(k, 0.0) for k in SCENARIO_SPANS},
                           "pack_host_s": (timer.take() if timer is not None
                                           else 0.0)}
        out.append((r, time.perf_counter() - t0))
    return out


def _distinct_nodes(bound, assignments) -> int:
    return len({p.node_name for p in bound} | set(assignments.values()))


def _host_quality(nodes, bound, placed, pods_by_key, last) -> dict:
    """The quality fields counted on the host, independent of the port,
    in f64: ``nodes_used`` (nodes holding a pod), ``headroom`` (mean over
    nodes of min(cpu, memory) free fraction), ``fragmentation`` (the share
    of free CPU on nodes whose free CPU is under the last batch's mean
    request) and ``priority_headroom`` (the last batch's placed pods'
    node free fraction, weighted by priority - min + 1). ``placed`` maps
    every placed pod to its node, ``last`` is the last cycle's result."""
    used = {nd.name: [0.0, 0.0, 0] for nd in nodes}
    for p in bound:
        u = used[p.node_name]
        u[0] += p.requests.cpu_milli
        u[1] += p.requests.memory
        u[2] += 1
    for key, node in placed.items():
        p = pods_by_key[key]
        u = used[node]
        u[0] += p.requests.cpu_milli
        u[1] += p.requests.memory
        u[2] += 1
    frac, free_cpu = {}, {}
    for nd in nodes:
        a, u = nd.allocatable, used[nd.name]
        free_cpu[nd.name] = max(a.cpu_milli - u[0], 0.0)
        frac[nd.name] = min(free_cpu[nd.name] / max(a.cpu_milli, 1e-9),
                            max(a.memory - u[1], 0.0) / max(a.memory, 1e-9))
    batch = list(last.assignments) + list(last.failure_reasons)
    mean_req = (sum(pods_by_key[k].requests.cpu_milli for k in batch)
                / max(len(batch), 1))
    total_free = sum(free_cpu.values())
    stranded = sum(v for v in free_cpu.values() if v < max(mean_req, 1e-9))
    pri = {k: pods_by_key[k].priority for k in last.assignments}
    lo = min(pri.values(), default=0)
    w = {k: v - lo + 1.0 for k, v in pri.items()}
    ph = (sum(w[k] * frac[n] for k, n in last.assignments.items())
          / max(sum(w.values()), 1e-9))
    return {"nodes_used": sum(1 for u in used.values() if u[2]),
            "headroom": sum(frac.values()) / max(len(nodes), 1),
            "fragmentation": stranded / max(total_free, 1e-9),
            "priority_headroom": ph}


def _tier_clean(tag, results, solver) -> None:
    for r, _w in results:
        if r.solver_tier != solver or r.solver_fallbacks:
            fail(f"{tag}: a cycle solved on {r.solver_tier!r} after "
                 f"{r.solver_fallbacks} fallbacks")


def scenario_arm_a(tmp: str) -> dict:
    """Arm A, cell ``scenario-5k-consolidation``: the smoke cell (5000
    nodes over 10 zones, 1000 bound, 10,000 pending of 100m / 500 Mi)
    through ``pack: consolidation`` at its defaults, under ``solver:
    batch`` and ``solver: sinkhorn``, each beside a stock twin with the
    same solver. Fails unless every pack solve places as many pods as its
    twin, the pack's ``nodes_used`` (the device reduction) is strictly
    below the twin's and equals the host's count of distinct nodes, and
    the capacity re-check passes."""
    out = {}
    for solver in ("batch", "sinkhorn"):
        row = {}
        for arm, pack in (("pack", "consolidation"), ("twin", "")):
            nodes, bound, pending = smoke_cell(SCENARIO["n_nodes"],
                                               SCENARIO["n_bound"],
                                               SCENARIO["n_pending"])
            sched = configured(_scenario_doc(pack, solver=solver), tmp,
                               f"scn-a-{solver}-{arm}")
            feed(sched, nodes, bound, [])
            results = _scenario_run(sched, pending)
            tag = f"scenario/A/{solver}/{arm}"
            _tier_clean(tag, results, solver)
            placed = {}
            for r, _w in results:
                placed.update(r.assignments)
            recheck_capacity(nodes, bound, placed,
                             {p.key(): p for p in pending})
            host_used = _distinct_nodes(bound, placed)
            rs = [r for r, _w in results]
            by_key = {p.key(): p for p in pending}
            host_q = _host_quality(nodes, bound, placed, by_key, rs[-1])
            row[arm] = {"scheduled": sum(r.scheduled for r in rs),
                        "attempted": [r.attempted for r in rs],
                        "pipeline_chunks": [r.pipeline_chunks for r in rs],
                        "rounds": [r.rounds for r in rs],
                        "host_syncs": [r.host_syncs for r in rs],
                        "cycle_s": [w for _r, w in results],
                        "solve_s": [r.solve_s for r in rs],
                        "scenario_host": [r.scenario_host for r in rs],
                        "nodes_used_host": host_used,
                        "host_quality": host_q}
            if pack:
                q = rs[-1].scenario_quality
                if not q:
                    fail(f"{tag}: no quality block on the last cycle")
                if q["nodes_used"] != host_used:
                    fail(f"{tag}: nodes_used {q['nodes_used']} on the "
                         f"device, {host_used} on the host")
                for k in ("headroom", "fragmentation", "priority_headroom"):
                    if abs(q[k] - host_q[k]) > 1e-3:
                        fail(f"{tag}: {k} {q[k]} on the device, "
                             f"{host_q[k]} on the host")
                row[arm].update({k: q[k] for k in (
                    "nodes_used", "nodes_used_batch", "placed", "headroom",
                    "fragmentation", "priority_headroom", "free_cpu_frac")})
                row[arm]["quality_by_cycle"] = [r.scenario_quality
                                                for r in rs]
                rec = sched.obs.recorder.records()[-1]
                if rec.scenario != q:
                    fail(f"{tag}: the flight record's scenario block "
                         f"{rec.scenario} is not the cycle's {q}")
            del sched
            release_graphs()
        pk, tw = row["pack"], row["twin"]
        if pk["scheduled"] != tw["scheduled"]:
            fail(f"scenario/A/{solver}: the pack placed {pk['scheduled']}, "
                 f"its twin {tw['scheduled']}")
        if not pk["nodes_used"] < tw["nodes_used_host"]:
            fail(f"scenario/A/{solver}: nodes_used {pk['nodes_used']} is "
                 f"not below the twin's {tw['nodes_used_host']}")
        out[solver] = row
    out["cycles"] = sum(len(row[a]["attempted"]) for row in out.values()
                        for a in ("pack", "twin"))
    return out


def scenario_arm_b(tmp: str) -> dict:
    """Arm B, cell ``scenario-5k-gang``: the reference bench's BASELINE
    config 4 (5000 nodes over 10 zones, 1000 gangs of 32
    ``make_gang_pods`` pods of 100m / 500 Mi) with ``pack:
    gang-topology`` at its defaults and ``maxBatch: 8192``, beside a stock
    twin. Fails unless every gang places whole (success rate 1.0 on
    every cycle, 0 partial binds), the pack's locality equals the host's
    count and is at or above the twin's, and the capacity re-check
    passes."""
    from kubernetes_tpu_torch.models.cluster import make_gang_pods, make_nodes

    row = {}
    for arm, pack in (("pack", "gang-topology"), ("twin", "")):
        nodes = make_nodes(SCENARIO["n_nodes"], zones=10)
        pods = make_gang_pods(SCENARIO["gangs"], SCENARIO["gang_size"])
        zone_of = {nd.name: nd.labels.get(ZONE) for nd in nodes}
        sched = configured(_scenario_doc(
            pack, maxBatch=SCENARIO["gang_max_batch"]), tmp,
            f"scn-b-{arm}")
        feed(sched, nodes, [], [])
        results = _scenario_run(sched, pods)
        tag = f"scenario/B/{arm}"
        _tier_clean(tag, results, "batch")
        placed = {}
        for r, _w in results:
            placed.update(r.assignments)
        recheck_capacity(nodes, [], placed, {p.key(): p for p in pods})
        groups: dict = {}
        for p in pods:
            groups.setdefault(p.pod_group, []).append(placed.get(p.key()))
        whole = sum(1 for v in groups.values() if all(v))
        partial = sum(1 for v in groups.values() if any(v) and not all(v))
        locality = _host_locality(groups, zone_of)
        rs = [r for r, _w in results]
        row[arm] = {"scheduled": sum(r.scheduled for r in rs),
                    "attempted": [r.attempted for r in rs],
                    "rounds": [r.rounds for r in rs],
                    "host_syncs": [r.host_syncs for r in rs],
                    "cycle_s": [w for _r, w in results],
                    "solve_s": [r.solve_s for r in rs],
                    "gangs_whole_host": whole, "gangs_partial_host": partial,
                    "gang_locality_host": locality}
        if partial or whole != len(groups):
            fail(f"{tag}: {whole} of {len(groups)} gangs whole, {partial} "
                 "partial")
        if pack:
            qs = [r.scenario_quality for r in rs]
            for q in qs:
                if q["gang_success_rate"] != 1.0 or q["gang_partial_binds"]:
                    fail(f"{tag}: a cycle's gang scores {q}")
            row[arm].update({
                "gang_success_rate": [q["gang_success_rate"] for q in qs],
                "gang_partial_binds": [q["gang_partial_binds"] for q in qs],
                "gang_locality": [q.get("gang_locality") for q in qs],
                "scenario_host": [r.scenario_host for r in rs]})
            # each cycle's locality is over its own gangs; their mean
            # weighted by gangs is the host's over all of them
            n_g = [q["gang_groups"] for q in qs]
            mean_q = sum(q["gang_locality"] * g
                         for q, g in zip(qs, n_g)) / sum(n_g)
            if abs(mean_q - locality) > 1e-3:
                fail(f"{tag}: the cycles' locality {mean_q} is not the "
                     f"host's {locality}")
        del sched
        release_graphs()
    if row["pack"]["gang_locality_host"] < row["twin"]["gang_locality_host"]:
        fail(f"scenario/B: locality {row['pack']['gang_locality_host']} "
             f"below the twin's {row['twin']['gang_locality_host']}")
    row["cycles"] = sum(len(v["attempted"]) for v in row.values())
    return row


def scenario_arm_c(tmp: str) -> dict:
    """Arm C, the cascade: cell ``preempt-5k-burst`` (wave 1: 4064
    ordinary pods and 32 preemptors on 5000 full nodes, a PDB) under
    ``pack: consolidation, preemptInBatch: true`` on a hand-advanced
    clock, until every preemptor is bound. Fails unless every preemptor
    binds in the cycle that preempted for it, on the node its victims
    left, every displaced pod re-places in that cycle or requeues, no
    guarded pod is evicted, the capacity re-check passes and
    ``scheduler_scenario_cascade_victims_total`` equals the victims
    evicted."""
    import torch

    nodes, bound, wave1, _poachers, pdb = preempt_cell(
        n_nodes=SCENARIO["n_nodes"], n_ordinary=SCENARIO["preempt_ordinary"])
    clock = FakeClock()
    events = []
    sched = configured(
        _scenario_doc("consolidation", scenario_preemptInBatch=True), tmp,
        "scn-c", clock=clock, pdb_lister=lambda: [pdb],
        event_sink=lambda r, p, m: events.append((r, p, m)))
    feed(sched, nodes, bound, wave1)
    by_key = {p.key(): p for p in bound + wave1}
    preemptors = {p.key() for p in wave1
                  if p.priority == PREEMPTOR_PRIORITY}
    results, walls, by_cycle = [], [], []
    bound_keys: set = set()
    for _ in range(6):
        del events[:]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = sched.schedule_cycle()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        results.append(r)
        by_cycle.append(list(events))
        bound_keys.update(r.assignments)
        if preemptors <= bound_keys:
            break
        clock.t += 11.0  # past the longest backoff (10 s)
    missing = preemptors - bound_keys
    if missing:
        fail(f"scenario/C: {len(missing)} preemptors never bound")
    victims, gone = [], set()
    replaced = requeued = 0
    for k, (r, evs) in enumerate(zip(results, by_cycle)):
        for reason, v, msg in evs:
            if reason != "Preempted":
                continue
            pre = msg[len("by "):].split(" ")[0]
            if not msg.endswith("(cascade)"):
                fail(f"scenario/C: victim {v.key()} evicted outside the "
                     f"cascade ({msg!r})")
            if pre not in r.assignments:
                fail(f"scenario/C: preemptor {pre} did not bind in cycle "
                     f"{k + 1}, which preempted {v.key()} for it")
            if v.priority >= by_key[pre].priority:
                fail(f"scenario/C: victim {v.key()} is not of lower "
                     "priority")
            if v.labels.get("app") == "guarded":
                fail(f"scenario/C: guarded pod {v.key()} was evicted")
            if v.key() in r.assignments:
                replaced += 1
            elif (v.key() in r.failure_reasons
                  and sched.queue.pod(v.key()) is not None) or any(
                      v.key() in later.assignments
                      for later in results[k + 1:]):
                requeued += 1
            else:
                fail(f"scenario/C: displaced pod {v.key()} neither "
                     "re-placed nor requeued")
            victims.append(v.key())
            gone.add(v.key())
    if len(set(victims)) != len(victims):
        fail("scenario/C: a victim was evicted twice")
    counted = sched.metrics.scenario_cascade_victims.value()
    if counted != len(victims) or sum(r.preempted for r in results) \
            != len(victims):
        fail(f"scenario/C: {len(victims)} victims evicted, "
             f"scheduler_scenario_cascade_victims_total {counted}, "
             f"preempted {[r.preempted for r in results]}")
    if not victims:
        fail("scenario/C: the cascade evicted nobody")
    assignments = {}
    for r in results:
        assignments.update(r.assignments)
    recheck_capacity(nodes, [p for p in bound if p.key() not in gone],
                     assignments, by_key)
    for r in results:
        if r.solver_tier != "batch" or r.solver_fallbacks:
            fail(f"scenario/C: a cycle solved on {r.solver_tier!r} after "
                 f"{r.solver_fallbacks} fallbacks")
    out = {"cycles": len(results), "wall_s": walls,
           "attempted": [r.attempted for r in results],
           "scheduled": [r.scheduled for r in results],
           "preempted": [r.preempted for r in results],
           "nominations": [len(r.nominations) for r in results],
           "preempt_s": [r.preempt_s for r in results],
           "host_syncs": [r.host_syncs for r in results],
           "victims": len(victims), "displaced_replaced_same_cycle":
           replaced, "displaced_requeued": requeued,
           "cascade_victims_total": counted,
           "displaced_replaced_total":
           sched.metrics.scenario_displaced_replaced.value(),
           "quality": [r.scenario_quality for r in results]}
    del sched
    release_graphs()
    return out


def scenario_restricted(tmp: str) -> dict:
    """Arm D, the restricted route: ``sparse-5k-churn``'s cluster and
    pods through ``incremental: {enabled, primary, candidateBucket: 256}``
    with ``pack: gang-topology, quality: false``: a 1024-pod burst, then
    steady cycles of 8 deletes and a micro-batch of 20 plain pods and 3
    gangs of 4 (no zone preference; they tolerate the taint). Fails
    unless a restricted cycle ran with a non-empty hint and every gang of
    a restricted cycle bound whole inside its home slice (none lost it to
    the top-C cut)."""
    import dataclasses
    import random

    from kubernetes_tpu_torch.api.types import Toleration
    from kubernetes_tpu_torch.testing import make_pod

    nodes, bound, cycles, _scopes, _misfit = sparse_traffic(
        n_nodes=SCENARIO["n_nodes"], n_bound=SCENARIO["n_bound"],
        burst=SCENARIO["restricted_burst"],
        steady=2 * SCENARIO["restricted_cycles"] + 2)
    sched = configured(_scenario_doc(
        "gang-topology", scenario_quality=False,
        incremental={"enabled": True, "primary": True,
                     "candidateBucket": 256}), tmp, "scn-d-restricted",
        enable_preemption=False)
    pack = sched.scenario_pack
    cur = []  # the hint calls of the cycle in flight
    real_hint = pack.candidate_hint

    def spy(batch, nt, node_order):
        h = real_hint(batch, nt, node_order)
        home = pack._home_zones(batch, nt)
        zone = nt.zone_id[: nt.n]
        cur.append({
            "hinted": 0 if h is None else int(h.sum()),
            "home": {p.key(): int(home[i]) for i, p in enumerate(batch)
                     if p.pod_group},
            "zone_of_node": {node_order[j]: int(zone[j])
                             for j in range(nt.n)}})
        return h

    pack.candidate_hint = spy
    rng = random.Random(5)
    gangs = [0]
    # gang members tolerate the autoscaler's taint: zone-0's nodes all
    # carry it (node i is in zone i % 10), and a gang homed there would
    # otherwise trade its home for TaintToleration's 10 points
    tol = (Toleration(key=SOFT_TAINT, operator="Exists",
                      effect="PreferNoSchedule"),)

    def gang_pods():
        out = []
        for _ in range(SCENARIO["restricted_gangs"]):
            g = gangs[0]
            gangs[0] += 1
            size = SCENARIO["restricted_gang_size"]
            out += [make_pod(f"dl-{g}-{m}", cpu_milli=100,
                             memory=500 * 2**20, pod_group=f"dl-{g}",
                             pod_group_min_available=size, tolerations=tol)
                    for m in range(size)]
        return out

    # the burst, then the steady micro-batches with gangs mixed in (the
    # traffic's node add and misfit cycles are left out: a node add takes
    # the cycle off the restricted route)
    steady = [(add, pend[: SCENARIO["restricted_plain"]] + gang_pods(), dl)
              for add, pend, dl in cycles[1:-1] if not add]
    steady = steady[: SCENARIO["restricted_cycles"]]

    placed = {p.key(): p for p in bound}
    feed(sched, nodes, bound, [])
    results, walls, hints = [], [], []
    for add, pending, deletes in [cycles[0]] + steady:
        del cur[:]
        for key in rng.sample(sorted(placed), deletes):
            sched.on_pod_delete(placed.pop(key))
        for p in pending:
            sched.on_pod_add(p)
        by_key = {p.key(): p for p in pending}
        t0 = time.perf_counter()
        r = sched.schedule_cycle()
        walls.append(time.perf_counter() - t0)
        results.append(r)
        hints.append(cur[-1] if cur else None)
        for key, node in r.assignments.items():
            p = dataclasses.replace(by_key[key], node_name=node)
            sched.on_pod_add(p)
            placed[key] = p
    restricted_hinted = 0
    gangs_checked = 0
    for r, h in zip(results, hints):
        if r.solve_scope != "restricted" or h is None or not h["home"]:
            continue
        if h["hinted"] > 0:
            restricted_hinted += 1
        groups: dict = {}
        for key, home in h["home"].items():
            groups.setdefault(key.rsplit("-", 1)[0], []).append((key, home))
        for members in groups.values():
            for key, home in members:
                node = r.assignments.get(key)
                if node is None:
                    fail(f"scenario/D: gang pod {key} unbound on a "
                         "restricted cycle")
                if h["zone_of_node"][node] != home:
                    fail(f"scenario/D: gang pod {key} on {node} (zone id "
                         f"{h['zone_of_node'][node]}), home {home}")
            gangs_checked += 1
    if not restricted_hinted:
        fail(f"scenario/D: no restricted cycle ran with a hint (scopes "
             f"{[r.solve_scope for r in results]})")
    recheck_capacity(nodes, [], {k: p.node_name for k, p in placed.items()},
                     placed)
    out = {"cycles": len(results),
           "scopes": [r.solve_scope for r in results],
           "restricted_hinted_cycles": restricted_hinted,
           "gangs_home_checked": gangs_checked,
           "hinted_columns": [h and h["hinted"] for h in hints],
           "cycle_s": walls, "host_syncs": [r.host_syncs for r in results]}
    del sched
    release_graphs()
    return out


def scenario_repack(tmp: str) -> dict:
    """Arm D, the re-pack: the smoke cell's 5000 nodes with its 1000 bound
    pods, one a node (a fragmented cluster), through ``pack:
    consolidation`` with ``repackInterval: 30s`` and ``repackMaxPods:
    64`` on a hand-advanced clock: cycles every 10-15 s, every bind
    confirmed. Fails unless the cycles between intervals drain nothing,
    each sweep drains at most ``repackMaxPods`` pods, and ``nodes_used``
    falls sweep after sweep (each drained pod re-placed in its sweep's
    cycle)."""
    import dataclasses

    nodes, bound, _ = smoke_cell(SCENARIO["n_nodes"], SCENARIO["n_bound"], 0)
    clock = FakeClock()
    sched = configured(_scenario_doc(
        "consolidation", scenario_repackInterval=(
            f"{int(SCENARIO['repack_interval_s'])}s"),
        scenario_repackMaxPods=SCENARIO["repack_max_pods"]), tmp,
        "scn-d-repack", clock=clock)
    feed(sched, nodes, bound, [])
    by_key = {p.key(): p for p in bound}
    drained_total = sched.metrics.scenario_repack_drained
    used = [_distinct_nodes(bound, {})]
    rows = []
    step = 0
    for step_s in [0.0] + [10.0, 11.0, 10.0] * SCENARIO["repack_sweeps"]:
        clock.t += step_s
        before = drained_total.value()
        sweeps0 = sched.metrics.scenario_repacks.value()
        t0 = time.perf_counter()
        r = sched.schedule_cycle()
        wall = time.perf_counter() - t0
        drained = drained_total.value() - before
        swept = sched.metrics.scenario_repacks.value() - sweeps0
        for key, node in r.assignments.items():
            by_key[key] = dataclasses.replace(by_key[key], node_name=node)
            sched.on_pod_add(by_key[key])
        rows.append({"t": clock.t, "drained": drained, "sweep": swept,
                     "scheduled": r.scheduled,
                     "nodes_used": r.scenario_quality.get("nodes_used"),
                     "wall_s": wall})
        step += 1
        if drained > SCENARIO["repack_max_pods"]:
            fail(f"scenario/D/repack: a sweep drained {drained} pods")
        if swept and r.scheduled != drained:
            fail(f"scenario/D/repack: the sweep at {clock.t}s drained "
                 f"{drained}, its cycle placed {r.scheduled}")
        if swept:
            used.append(r.scenario_quality["nodes_used"])
            host = len({p.node_name for p in by_key.values()})
            if used[-1] != host:
                fail(f"scenario/D/repack: nodes_used {used[-1]}, host "
                     f"{host}")
    sweep_times = [row["t"] for row in rows if row["sweep"]]
    for row in rows:
        if row["drained"] and not row["sweep"]:
            fail("scenario/D/repack: pods drained outside a sweep")
    gaps = [b - a for a, b in zip(sweep_times, sweep_times[1:])]
    if any(g < SCENARIO["repack_interval_s"] for g in gaps):
        fail(f"scenario/D/repack: sweeps at {sweep_times}")
    if len(used) < 3 or any(b >= a for a, b in zip(used, used[1:])):
        fail(f"scenario/D/repack: nodes_used {used} does not fall sweep "
             "after sweep")
    out = {"cycles": len(rows), "rows": rows, "nodes_used": used,
           "sweeps": len(sweep_times)}
    del sched
    release_graphs()
    return out


def _gang_smoke_pods(n, seed, group_size=8, prefix="gw"):
    """``n`` smoke-cell pods (100m / 500 Mi, a preferred zone, half
    tolerating the taint) named ``prefix-i``, in gangs of ``group_size``
    (0: no gangs)."""
    import dataclasses

    pods = smoke_cell(0, 0, n, seed)[2]
    return [dataclasses.replace(
        p, name=f"{prefix}-{i}",
        pod_group=f"{prefix}-g{i // group_size}" if group_size else "",
        pod_group_min_available=group_size) for i, p in enumerate(pods)]


def scenario_warm(tmp: str) -> dict:
    """Each pack's scheduler (the smoke cluster, ``warmup: {enabled,
    podBuckets: [256]}``) warms with a sample of its cycles' pods, then
    runs three cycles of 200: 0 graph captures and 0 signature retraces
    after the warmup."""
    from kubernetes_tpu_torch.ops import device_loop

    out = {}
    for pack in ("consolidation", "gang-topology"):
        nodes, bound, _ = smoke_cell(SCENARIO["n_nodes"],
                                     SCENARIO["n_bound"], 0)
        n = SCENARIO["warm_pods"]
        make = ((lambda k: _gang_smoke_pods(n, 40 + k, group_size=0,
                                            prefix=f"cw{k}"))
                if pack == "consolidation"
                else (lambda k: _gang_smoke_pods(n, 40 + k,
                                                 prefix=f"gw{k}")))
        sched = configured(_scenario_doc(
            pack, warmup={"enabled": True,
                          "podBuckets": [SCENARIO["warm_bucket"]]}), tmp,
            f"scn-warm-{pack}", enable_preemption=False)
        feed(sched, nodes, bound, [])
        c0 = device_loop.CAPTURES.count
        t0 = time.perf_counter()
        warmed = sched.warmup(sample_pods=make(9)[:64])
        warm_s = time.perf_counter() - t0
        warm_captures = device_loop.CAPTURES.count - c0
        rows = []
        for k in range(3):
            results = _scenario_run(sched, make(k), max_cycles=1)
            r, w = results[0]
            rows.append({"scheduled": r.scheduled, "captures":
                         r.graph_captures, "syncs": r.host_syncs,
                         "cycle_s": w, "quality": r.scenario_quality})
        retraces = sched.obs.jax.retrace_total()
        if warmed <= 0 or warm_captures <= 0:
            fail(f"scenario/warm/{pack}: warmup warmed {warmed}, captured "
                 f"{warm_captures}")
        if any(row["captures"] for row in rows) or retraces:
            fail(f"scenario/warm/{pack}: {[row['captures'] for row in rows]}"
                 f" captures, {retraces} retraces after warmup")
        if any(row["scheduled"] != n for row in rows):
            fail(f"scenario/warm/{pack}: {[row['scheduled'] for row in rows]}"
                 f" of {n} bound")
        out[pack] = {"warmed": warmed, "warmup_s": warm_s,
                     "warm_captures": warm_captures, "rows": rows,
                     "retraces": retraces}
        del sched
        release_graphs()
    out["cycles"] = 6
    return out


def _equality_run(tmp, pack, device, quality=True, sync_check=False):
    """One cycle of the equality cell (500 nodes, 1024 pods) with ``pack``
    on ``device``: the result, the raw quality vector read back, and the
    cycle's host syncs (with ``sync_check`` the whole cycle under
    ``torch.cuda.set_sync_debug_mode("error")``)."""
    import torch

    nodes, bound, _ = smoke_cell(SCENARIO["eq_nodes"], 100, 0)
    n = SCENARIO["eq_pods"]
    pods = _gang_smoke_pods(n, 23, prefix="eq",
                            group_size=32 if pack == "gang-topology" else 0)
    sched = configured(_scenario_doc(pack, scenario_quality=quality), tmp,
                       f"scn-eq-{pack}-{device}-{quality}", device=device,
                       enable_preemption=False)
    feed(sched, nodes, bound, pods)
    raw = []
    real = sched.obs.jax.readback

    def spy(site, x):
        got = real(site, x)
        if site == "scenario-quality":
            raw.append(list(got))
        return got

    sched.obs.jax.readback = spy
    if sync_check:
        torch.cuda.set_sync_debug_mode("error")
    try:
        r = sched.schedule_cycle()
    finally:
        if sync_check:
            torch.cuda.set_sync_debug_mode(0)
    del sched
    return r, (raw[-1] if raw else None)


def scenario_equality(tmp: str) -> dict:
    """Both packs at 500 nodes x 1024 pods on the card and on CPU tensors:
    equal placements and counts, the four fractions within the unit
    test's tolerance. Then one quality-on cycle of each pack under
    ``torch.cuda.set_sync_debug_mode("error")``: its host syncs are its
    quality-off twin's plus one (the ``scenario-quality`` read)."""
    out = {}
    for pack in ("consolidation", "gang-topology"):
        rc, qc = _equality_run(tmp, pack, "cuda")
        rh, qh = _equality_run(tmp, pack, "cpu")
        if rc.assignments != rh.assignments:
            n = sum(rh.assignments.get(k) != v
                    for k, v in rc.assignments.items())
            fail(f"scenario/eq/{pack}: placements differ on {n} pods")
        fields = ("nodes_used", "nodes_used_batch", "placed", "headroom",
                  "fragmentation", "priority_headroom", "free_cpu_frac")
        got = dict(zip(fields, qc))
        want = dict(zip(fields, qh))
        for k in QUALITY_COUNTS:
            if got[k] != want[k]:
                fail(f"scenario/eq/{pack}: {k} {got[k]} on the card, "
                     f"{want[k]} on the CPU")
        err = {}
        for k in QUALITY_FRACTIONS:
            err[k] = abs(got[k] - want[k])
            if err[k] > QUALITY_ATOL + QUALITY_RTOL * abs(want[k]):
                fail(f"scenario/eq/{pack}: {k} {got[k]} on the card, "
                     f"{want[k]} on the CPU")
        release_graphs()
        on, _q = _equality_run(tmp, pack, "cuda", sync_check=True)
        off, _q = _equality_run(tmp, pack, "cuda", quality=False,
                                sync_check=True)
        stock, _q = _equality_run(tmp, "", "cuda", sync_check=True) \
            if pack == "consolidation" else (None, None)
        if on.host_syncs != off.host_syncs + 1:
            fail(f"scenario/eq/{pack}: a quality-on cycle made "
                 f"{on.host_syncs} syncs, its quality-off twin "
                 f"{off.host_syncs}")
        if on.assignments != off.assignments:
            fail(f"scenario/eq/{pack}: quality on and off placed apart")
        out[pack] = {"equal": True, "scheduled": rc.scheduled,
                     "quality_cuda": got, "quality_cpu": want,
                     "fraction_abs_err": err,
                     "syncs_quality_on": on.host_syncs,
                     "syncs_quality_off": off.host_syncs,
                     "syncs_stock": (stock.host_syncs if stock is not None
                                     else None)}
        release_graphs()
    out["cycles"] = 9  # 2 x (card, CPU, quality on, off) + the stock one
    return out


def phase_scenario() -> dict:
    """The scenario packs on the card, every scheduler from a JSON v1alpha1
    file through ``Scheduler.from_config``: arm A (consolidation, both
    solvers, beside stock twins), arm B (gang-topology on the BASELINE
    gangs), arm C (the in-batch cascade on the preempt cell), arm D (the
    restricted route with the gang pack's hint, and the re-pack), each
    pack's warmup, and the CUDA/CPU equality and sync checks, all counted
    from 0 together. Fails unless the pair and the u and v passes
    launched (the pair under the gang pack on the smoke cell's pods; u / v
    under ``solver: sinkhorn``)."""
    import tempfile

    from kubernetes_tpu_torch import kernels

    kernels.reset_launches()
    out = {}
    cycles = 0
    with tempfile.TemporaryDirectory(prefix="ktt-scenario-") as tmp:
        for arm, run in (("A", scenario_arm_a), ("B", scenario_arm_b),
                         ("C", scenario_arm_c),
                         ("D-restricted", scenario_restricted),
                         ("D-repack", scenario_repack),
                         ("warmup", scenario_warm),
                         ("equality", scenario_equality)):
            t0 = time.perf_counter()
            before = launch_counts()
            got = run(tmp)
            wall = time.perf_counter() - t0
            launches = _launches_since(before)
            emit({"phase": "scenario", "arm": arm, "wall_s": wall,
                  "launches": launches, **got})
            out[arm] = {"wall_s": wall, "launches": launches}
            cycles += got["cycles"]
    launches, shapes = launch_counts(), launch_shapes()
    for name in ARRAY_KERNELS:
        if launches[name] <= 0:
            fail(f"scenario: {name} was never launched")
    return {"launches": launches, "shapes": shapes, "cycles": cycles,
            "arms": out}


# ---------------------------------------------------------------------------
# phase 17: the protobuf codec and the gRPC seam
# ---------------------------------------------------------------------------

#: cell ``grpc-5k-deltas``: arm A at full width (the smoke cell's cluster,
#: 4096 delta-fed pods, 64 pods through the extender verbs and Bind), arm
#: B the reference integration test's convergence on a hub cut to 1000
#: nodes and 500 pods (each hub step is seconds of host Python at 5000
#: nodes), arm C arm A's stream cut to 500 nodes for the CUDA/CPU run
GRPC = {"n_nodes": 5000, "n_bound": 1000, "n_pending": 4096,
        "n_verb_pods": 64, "rest_page": 1000, "codec_reps": 3,
        "hub_nodes": 1000, "hub_pods": 500, "hub_replicas": 64,
        "hub_killed": 16,
        "eq_nodes": 500, "eq_bound": 100, "eq_pending": 1024,
        "eq_verb_pods": 16}
GRPC_TOKEN = "chip-smoke-seam-token"


class LoopbackSeam:
    """The seam's transport where ``grpcio`` is absent: in process, but
    every request and every response is serialized with the port's codec
    and parsed on the other side (the classes of ``grpc_shim.METHODS``),
    and every verb passes the service's bearer-token gate
    (``grpc_shim._authed``) with the client's metadata. The client half
    has the verbs of ``GrpcSchedulerClient`` and kubectl's
    ``get_state_snapshot``; ``sent`` / ``received`` count the bytes."""

    target = "loopback"

    class Refused(Exception):
        """The token gate aborted the call (grpc's UNAUTHENTICATED)."""

    def __init__(self, svc, token, client_token) -> None:
        from kubernetes_tpu_torch import grpc_shim

        self.sent = self.received = 0
        md = ([("authorization", f"Bearer {client_token}")]
              if client_token else [])
        refused = self.Refused

        class Context:
            def invocation_metadata(self):
                return md

            def abort(self, code, details):
                raise refused(f"{code}: {details}")

        ctx = Context()
        for streaming, method, req, resp in grpc_shim.METHODS.values():
            behavior = grpc_shim._authed(getattr(svc, method), token,
                                         "UNAUTHENTICATED")
            make = self._stream if streaming else self._unary
            setattr(self, method, make(behavior, ctx, req, resp))

    def _unary(self, behavior, ctx, req, resp):
        def call(request):
            data = request.SerializeToString()
            self.sent += len(data)
            out = behavior(req.FromString(data), ctx).SerializeToString()
            self.received += len(out)
            return resp.FromString(out)

        return call

    def _stream(self, behavior, ctx, req, resp):
        def call(requests):
            def wire():
                for r in requests:
                    data = r.SerializeToString()
                    self.sent += len(data)
                    yield req.FromString(data)

            for ack in behavior(wire(), ctx):
                out = ack.SerializeToString()
                self.received += len(out)
                yield resp.FromString(out)

        return call

    def get_state_snapshot(self):
        from kubernetes_tpu_torch.proto import extender as pb

        return self.get_state(pb.StateRequest())

    def close(self) -> None:
        pass


def grpc_seam(svc, client_token=GRPC_TOKEN):
    """The seam's client over ``svc``: ``serve_grpc`` on 127.0.0.1 (token
    gated) with a ``GrpcSchedulerClient`` where ``grpcio`` imports, else
    the :class:`LoopbackSeam`. Returns ``(client, kubectl client, close,
    transport)``; the transport names the one that ran."""
    from kubernetes_tpu_torch import grpc_shim, kubectl

    try:
        import grpc  # noqa: F401
    except ImportError:
        seam = LoopbackSeam(svc, GRPC_TOKEN, client_token)
        return seam, seam, seam.close, "loopback (grpcio absent)"
    server, port = grpc_shim.serve_grpc(svc.scheduler, service=svc,
                                        token=GRPC_TOKEN)
    client = grpc_shim.GrpcSchedulerClient(f"127.0.0.1:{port}",
                                           token=client_token)
    kc = kubectl._Client(f"127.0.0.1:{port}", token=client_token)

    def close():
        client.close()
        kc.close()
        server.stop(grace=None)

    return client, kc, close, "grpc (serve_grpc on 127.0.0.1)"


def token_refused(svc) -> bool:
    """A client with a wrong token is refused by the seam's gate."""
    from kubernetes_tpu_torch.proto import extender as pb

    client, _, close, _ = grpc_seam(svc, client_token="forged")
    try:
        client.get_state(pb.StateRequest())
    except Exception as e:  # grpc.RpcError or LoopbackSeam.Refused
        code = getattr(e, "code", None)
        return "UNAUTHENTICATED" in str(code() if callable(code) else e)
    finally:
        close()
    return False


class AckTap:
    """Wraps a client's ``sync_state``: records (delta revision, acked
    revision) for every delta sent."""

    def __init__(self, client) -> None:
        self.client = client
        self.pairs: list = []

    def sync_state(self, requests):
        sent = []

        def tap():
            for d in requests:
                sent.append(d.revision)
                yield d

        # one ack per delta, in order
        for i, ack in enumerate(self.client.sync_state(tap())):
            self.pairs.append((sent[i], ack.revision))
            yield ack


class CountingBinder:
    """The hub's CAS Binding subresource (``sim.FlakyBinder`` with no
    injected failures), counting the binds of each pod."""

    def __init__(self, hub) -> None:
        import random

        from kubernetes_tpu_torch.sim import FlakyBinder

        self.inner = FlakyBinder(hub, 0.0, random.Random(0))
        self.count: dict = {}

    @property
    def conflicts(self) -> int:
        return self.inner.conflicts

    def bind(self, pod, node_name: str) -> None:
        self.inner.bind(pod, node_name)
        self.count[pod.key()] = self.count.get(pod.key(), 0) + 1


def checked_bridge(hub, client, phase: str):
    """A ``SnapshotDeltaBridge`` whose every typed payload is checked as it
    is streamed: the bytes decode (``from_pb``) to the object the JSON
    slice gives (``from_json(to_json(x))`` through ``json.dumps``)."""
    from kubernetes_tpu_torch.api.protobuf import (
        node_from_pb,
        node_to_pb,
        pod_from_pb,
    )
    from kubernetes_tpu_torch.extender import node_from_json
    from kubernetes_tpu_torch.grpc_shim import SnapshotDeltaBridge
    from kubernetes_tpu_torch.proto import corev1
    from kubernetes_tpu_torch.server import pod_from_json

    class CheckedBridge(SnapshotDeltaBridge):
        checked = 0

        def _payload(self, obj, to_pb, to_json, pb_field, json_field):
            got = super()._payload(obj, to_pb, to_json, pb_field, json_field)
            if obj is None:
                return got
            if pb_field not in got:
                fail(f"{phase}: the bridge sent {json_field}, not typed "
                     "payloads (KTPU_PROTO_FEED)")
            node = to_pb is node_to_pb
            msg = (corev1.NodeMsg if node else corev1.PodMsg).FromString(
                got[pb_field])
            back = (node_from_pb if node else pod_from_pb)(msg)
            want = (node_from_json if node else pod_from_json)(
                json.loads(json.dumps(to_json(obj))))
            if back != want:
                fail(f"{phase}: {json_field[:3]} {getattr(obj, 'name', '')} "
                     "decodes from its typed payload unlike its JSON")
            CheckedBridge.checked += 1
            return got

    return CheckedBridge(hub, client)


class RevisionCheck:
    """After each pump: every delta was acked with its own revision, and
    the last ack is the hub's revision of its last node or pod event
    (read by a cursor of its own)."""

    def __init__(self, hub, acks: AckTap, phase: str) -> None:
        self.last = hub.list_state()[0]
        self.cursor = hub.watch(self.last)
        self.acks, self.phase = acks, phase
        self.checks = 0

    def __call__(self) -> None:
        for rev, key, _etype, _obj in self.cursor.poll():
            if key.startswith(("nodes/", "pods/")):
                self.last = max(self.last, rev)
        bad = [p for p in self.acks.pairs if p[0] != p[1]]
        if bad:
            fail(f"{self.phase}: acks differ from their deltas' revisions: "
                 f"{bad[:3]}")
        if self.acks.pairs and self.acks.pairs[-1][1] != self.last:
            fail(f"{self.phase}: acked revision {self.acks.pairs[-1][1]}, "
                 f"the hub's is {self.last}")
        self.checks += 1


def _kubectl_render(kc, snap, n_nodes: int, n_pods: int) -> dict:
    """One GetState rendered by kubectl's ``cmd_get``, ``cmd_top`` and
    ``cmd_describe`` through a ``State``; output captured and checked."""
    import contextlib
    import io

    from kubernetes_tpu_torch import kubectl

    class OneState:
        """kubectl's client over one snapshot: every verb reads ``snap``;
        Filter and Prioritize still go over the seam."""

        def get_state_snapshot(self):
            return snap

        def __getattr__(self, name):
            return getattr(kc, name)

    st = kubectl.State(snap)
    first_pod = st.bound[0]["metadata"]["name"]
    out = {}
    for name, fn, ns in (
            ("get_nodes", kubectl.cmd_get, {"kind": "nodes"}),
            ("get_pods", kubectl.cmd_get, {"kind": "pods",
                                           "namespace": None,
                                           "all_namespaces": True}),
            ("top_nodes", kubectl.cmd_top, {"kind": "nodes"}),
            ("describe_node", kubectl.cmd_describe,
             {"kind": "node", "name": "node-1"}),
            ("describe_pod", kubectl.cmd_describe,
             {"kind": "pod", "name": first_pod})):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fn(OneState(), argparse.Namespace(**ns))
        text = buf.getvalue()
        if rc != 0:
            fail(f"grpc: kubectl {name} exited {rc}")
        out[name] = text
    lines = {k: v.count("\n") for k, v in out.items()}
    if (lines["get_nodes"] != n_nodes + 1 or lines["top_nodes"] != n_nodes + 1
            or lines["get_pods"] != n_pods + 1
            or out["get_pods"].count(" Bound ") != n_pods
            or "Pods (" not in out["describe_node"]
            or "Node:       node-" not in out["describe_pod"]
            or len(st.nodes) != n_nodes or len(st.bound) != n_pods
            or st.pending):
        fail(f"grpc: kubectl rendered {lines} over {len(st.nodes)} nodes, "
             f"{len(st.bound)} bound and {len(st.pending)} pending pods")
    return {"lines": lines, "revision": st.revision}


def codec_times(hub, reps: int) -> dict:
    """The whole node list on the card's host: bytes, encode and decode
    seconds of the protobuf envelope (the port's codec) and of JSON
    (``json.dumps`` / ``json.loads`` of the same list), the median of
    ``reps`` runs each; both decodes must give the same nodes."""
    from kubernetes_tpu_torch.api.protobuf import (
        decode_envelope,
        encode_envelope,
        node_from_pb,
        node_list_to_pb,
    )
    from kubernetes_tpu_torch.extender import node_from_json, node_to_json
    from kubernetes_tpu_torch.proto import corev1

    nodes = sorted(hub.truth_nodes.values(), key=lambda n: n.name)
    times = {"pb_encode_s": [], "json_encode_s": [], "pb_decode_s": [],
             "json_decode_s": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        pb_bytes = encode_envelope("NodeList", node_list_to_pb(nodes, 1))
        t1 = time.perf_counter()
        js_bytes = json.dumps({"kind": "NodeList", "apiVersion": "v1",
                               "items": [node_to_json(n) for n in nodes]}
                              ).encode()
        t2 = time.perf_counter()
        back_pb = [node_from_pb(m) for m in corev1.NodeListMsg.FromString(
            decode_envelope(pb_bytes)[1]).items]
        t3 = time.perf_counter()
        back_js = [node_from_json(d) for d in json.loads(js_bytes)["items"]]
        t4 = time.perf_counter()
        for k, v in zip(times, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            times[k].append(v)
    if back_pb != back_js:
        fail("grpc: the protobuf node list decodes unlike the JSON one")
    return {"nodes": len(nodes), "pb_bytes": len(pb_bytes),
            "json_bytes": len(js_bytes),
            "bytes_ratio_json_over_pb": len(js_bytes) / len(pb_bytes),
            **{k: statistics.median(v) for k, v in times.items()}}


def grpc_stream(device: str, n_nodes: int, n_bound: int, n_pending: int,
                n_verb_pods: int, full: bool, seed: int = 7) -> dict:
    """Arm A (``full``) or its reduced run: the smoke cell's cluster on a
    ``sim.HollowCluster``, listed by a checked ``SnapshotDeltaBridge`` as
    typed deltas; ``n_pending`` pods created in the hub arrive as PodDelta
    ADDs; a service-side ``Scheduler(device=device)`` (default solver)
    schedules cycles until its queue is empty, binding through the hub's
    CAS binder, the watch echo confirming; then ``n_verb_pods`` more pods
    go through the seam's Filter (every node name), Prioritize (the
    feasible names) and Bind (the best score), each answer held against
    the ``ExtenderServer`` JSON verbs'. With ``full``, one GetState
    rendered by kubectl, the REST lists in protobuf and the codec's
    times. Every pod must bind exactly once."""
    from kubernetes_tpu_torch.extender import pod_to_json
    from kubernetes_tpu_torch.grpc_shim import TpuSchedulerService
    from kubernetes_tpu_torch.kubectl import RestClient
    from kubernetes_tpu_torch.proto import extender as pb
    from kubernetes_tpu_torch.restapi import RestServer
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.sim import HollowCluster

    tag = f"grpc[{device}]"
    t_start = time.perf_counter()
    nodes, bound, pending = smoke_cell(n_nodes, n_bound,
                                       n_pending + n_verb_pods, seed)
    pending, verb_pods = pending[:n_pending], pending[n_pending:]
    # the hub's own scheduler is never cycled: the service's schedules
    hub = HollowCluster(seed=seed, scheduler_kw={"device": device})
    for nd in nodes:
        hub.add_node(nd)
    for p in bound:
        hub.create_pod(p)
    binder = CountingBinder(hub)
    sched = Scheduler(device=device, clock=hub.clock, binder=binder)
    svc = TpuSchedulerService(sched)
    client, kc, close, transport = grpc_seam(svc)
    acks = AckTap(client)
    try:
        revs = RevisionCheck(hub, acks, tag)
        t0 = time.perf_counter()
        bridge = checked_bridge(hub, acks, tag)
        list_s = time.perf_counter() - t0
        revs()
        for p in pending:
            hub.create_pod(p)
        t0 = time.perf_counter()
        bridge.pump()
        feed_s = time.perf_counter() - t0
        revs()
        if sched.cache.node_count() != n_nodes or len(sched.queue) != len(
                pending):
            fail(f"{tag}: the service holds {sched.cache.node_count()} "
                 f"nodes and {len(sched.queue)} queued pods")
        cycles, cycle_s, echo_s = [], [], 0.0
        for _ in range(16):
            t0 = time.perf_counter()
            with svc.lock:
                r = sched.schedule_cycle()
            cycle_s.append(time.perf_counter() - t0)
            if r.attempted == 0:
                break
            if r.solver_tier != "batch" or r.solver_fallbacks:
                fail(f"{tag}: a cycle solved on {r.solver_tier!r} after "
                     f"{r.solver_fallbacks} fallbacks")
            cycles.append(r)
            t0 = time.perf_counter()
            bridge.pump()
            echo_s += time.perf_counter() - t0
            revs()
        if len(sched.queue):
            fail(f"{tag}: {len(sched.queue)} pods still queued")
        # the extender verbs and Bind over the seam, node names only
        for p in verb_pods:
            hub.create_pod(p)
        bridge.pump()
        revs()
        names = [nd.name for nd in nodes]
        verbs_s, verb_rows = 0.0, []
        for p in verb_pods:
            doc = pod_to_json(hub.truth_pods[p.key()])
            t0 = time.perf_counter()
            fr = client.filter(pb.ExtenderArgs(pod_json=json.dumps(doc),
                                               node_names=names))
            feasible = list(fr.node_names)
            pr = client.prioritize(pb.ExtenderArgs(
                pod_json=json.dumps(doc), node_names=feasible))
            verbs_s += time.perf_counter() - t0
            want_f = svc.extender.handle("filter", {"pod": doc,
                                                    "nodenames": names})
            want_p = svc.extender.handle("prioritize",
                                         {"pod": doc, "nodenames": feasible})
            if (fr.error or feasible != want_f["nodenames"]
                    or dict(fr.failed_nodes) != want_f["failedNodes"]
                    or pr.error
                    or [(i.host, i.score) for i in pr.items]
                    != [(d["host"], d["score"]) for d in want_p]):
                fail(f"{tag}: Filter/Prioritize for {p.key()} differ from "
                     "the ExtenderServer JSON verbs")
            if not pr.items:
                fail(f"{tag}: no feasible node for {p.key()}")
            best = max(pr.items, key=lambda i: i.score)
            t0 = time.perf_counter()
            res = client.bind(pb.Binding(pod_key=p.key(), node=best.host))
            verbs_s += time.perf_counter() - t0
            if not res.ok:
                fail(f"{tag}: Bind {p.key()} -> {best.host}: {res.error}")
            verb_rows.append((len(feasible), best.score))
        bridge.pump()
        revs()
        keys = [p.key() for p in pending + verb_pods]
        once = [k for k in keys if binder.count.get(k) != 1
                or not hub.truth_pods[k].node_name]
        if once or binder.conflicts or any(sched.cache.is_assumed(k)
                                           for k in keys):
            fail(f"{tag}: {len(once)} pods not bound exactly once (e.g. "
                 f"{once[:3]}), {binder.conflicts} conflicts")
        assignments = {k: hub.truth_pods[k].node_name for k in keys}
        by_key = {p.key(): p for p in pending + verb_pods}
        recheck_capacity(nodes, bound, assignments, by_key)
        if not token_refused(svc):
            fail(f"{tag}: a forged token passed the seam's gate")
        out = {"transport": transport, "nodes": n_nodes,
               "bound": n_bound, "pending": n_pending,
               "verb_pods": n_verb_pods, "cycles": len(cycles),
               "attempted": [r.attempted for r in cycles],
               "pipeline_chunks": [r.pipeline_chunks for r in cycles],
               "rounds": [r.rounds for r in cycles],
               "cycle_s": cycle_s, "list_s": list_s, "feed_s": feed_s,
               "echo_s": echo_s, "verbs_s": verbs_s,
               "verb_feasible_min": min(f for f, _ in verb_rows),
               "streamed_checked": type(bridge).checked,
               "acks": len(acks.pairs), "ack_checks": revs.checks,
               "placements": sorted(assignments.items())}
        if isinstance(client, LoopbackSeam):
            out["loopback_bytes"] = {"sent": client.sent,
                                     "received": client.received}
        if full:
            t0 = time.perf_counter()
            snap = kc.get_state_snapshot()
            out["get_state_s"] = time.perf_counter() - t0
            out["kubectl"] = _kubectl_render(
                kc, snap, n_nodes, n_bound + n_pending + n_verb_pods)
            server = RestServer(hub)
            port = server.serve()
            try:
                t0 = time.perf_counter()
                out["rest"] = rest_protobuf(RestClient(f"127.0.0.1:{port}"),
                                            tag, GRPC["rest_page"])
                out["rest_s"] = time.perf_counter() - t0
            finally:
                server.close()
            out["codec"] = codec_times(hub, GRPC["codec_reps"])
    finally:
        close()
    out["wall_s"] = time.perf_counter() - t_start
    return out


def grpc_converge() -> dict:
    """Arm B, the reference integration test's convergence
    (``tests/test_integration_grpc_hub.py``) on the card: a hub of 1000 of
    the smoke cell's nodes and 500 of its pods driven by a remote service
    (``solver="sinkhorn"``) through the bridge — pump, a cycle under the
    service lock, pump — until every pod is bound, the service's cache
    equal to the hub's truth and no assumption left to expire; then a
    ReplicaSet placed, one churn step killing bound pods and the
    controller's refeed placed again."""
    from kubernetes_tpu_torch.debugger import compare
    from kubernetes_tpu_torch.grpc_shim import TpuSchedulerService
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.sim import HollowCluster, ReplicaSet

    t_start = time.perf_counter()
    nodes, _, pending = smoke_cell(GRPC["hub_nodes"], 0, GRPC["hub_pods"])
    hub = HollowCluster(seed=21, scheduler_kw={"device": "cuda"})
    for nd in nodes:
        hub.add_node(nd)
    for p in pending:
        hub.create_pod(p)
    binder = CountingBinder(hub)
    remote = Scheduler(device="cuda", solver="sinkhorn", clock=hub.clock,
                       enable_preemption=False, binder=binder)
    svc = TpuSchedulerService(remote)
    client, _, close, transport = grpc_seam(svc)
    steps = []

    def step() -> int:
        bridge.pump()
        t0 = time.perf_counter()
        with svc.lock:
            r = remote.schedule_cycle()
        steps.append(time.perf_counter() - t0)
        if r.attempted and (r.solver_tier != "sinkhorn"
                            or r.solver_fallbacks):
            fail(f"grpc: arm B solved on {r.solver_tier!r} after "
                 f"{r.solver_fallbacks} fallbacks")
        bridge.pump()
        return r.scheduled

    def oracle(when: str) -> None:
        truth = {k: p.node_name for k, p in hub.truth_pods.items()}
        nd, pd = compare(remote, truth, list(hub.truth_nodes))
        if nd or pd:
            fail(f"grpc: arm B's service differs from the hub {when}: "
                 f"{nd[:3]} {pd[:3]}")

    try:
        bridge = checked_bridge(hub, client, "grpc[B]")
        total = 0
        for _ in range(10):
            total += step()
            hub.clock.advance(2.0)
            if total >= len(pending):
                break
        if total != len(pending) or hub.bound_total != len(pending) \
                or binder.conflicts:
            fail(f"grpc: arm B bound {total} of {len(pending)} "
                 f"(hub {hub.bound_total}, {binder.conflicts} conflicts)")
        oracle("after convergence")
        converge_steps = len(steps)
        hub.clock.advance(60.0)
        if remote.cache.cleanup_expired():
            fail("grpc: arm B left assumptions to expire")
        hub.add_replicaset(ReplicaSet("web", replicas=GRPC["hub_replicas"]))
        for _ in range(4):
            hub.reconcile_controllers()
            step()
            hub.clock.advance(2.0)
        hub.churn(kill_pods=GRPC["hub_killed"])
        for _ in range(6):
            hub.reconcile_controllers()
            step()
            hub.clock.advance(2.0)
        rs = hub.replicasets["web"]
        live = [hub.truth_pods[k] for k in rs.live if k in hub.truth_pods]
        unbound = [k for k, p in hub.truth_pods.items() if not p.node_name]
        if len(live) != GRPC["hub_replicas"] or unbound:
            fail(f"grpc: arm B after churn: {len(live)} replicas live, "
                 f"{len(unbound)} pods unbound")
        oracle("after the churn step")
        twice = [k for k, n in binder.count.items() if n != 1]
        if twice:
            fail(f"grpc: arm B bound {twice[:3]} more than once")
    finally:
        close()
    return {"transport": transport, "nodes": len(nodes),
            "pods": len(pending), "converge_steps": converge_steps,
            "steps": len(steps), "cycle_s": steps,
            "binds": sum(binder.count.values()),
            "streamed_checked": type(bridge).checked,
            "wall_s": time.perf_counter() - t_start}


def phase_grpc() -> dict:
    """Cell ``grpc-5k-deltas``: the protobuf codec and the gRPC seam on
    the card's machine, over ``serve_grpc`` where ``grpcio`` imports and
    the in-process loopback where it does not (the line names which).
    Arm A at full width (the general round: the nodes' soft taints keep
    TaintToleration live, the wire slice leaves the pods no preference,
    so the pair cannot launch), arm B (``solver: sinkhorn``) must launch
    u and v, arm C holds arm A's stream at 500 nodes equal on CUDA and on
    CPU tensors; all counted from 0 together."""
    from kubernetes_tpu_torch import kernels

    kernels.reset_launches()
    out = {}
    before = launch_counts()
    a = grpc_stream("cuda", GRPC["n_nodes"], GRPC["n_bound"],
                    GRPC["n_pending"], GRPC["n_verb_pods"], full=True)
    a["launches"] = _launches_since(before)
    # no pair here: the wire slice (JSON and protobuf alike, the
    # reference's too) carries no affinity and no tolerations, so a
    # delta-fed scheduler gates NodeAffinityPriority off, and the fused
    # pair runs only with both NodeAffinity and TaintToleration live
    cycles = a["cycles"]
    a.pop("placements")
    emit({"phase": "grpc", "arm": "A", "cell": "grpc-5k-deltas", **a})
    out["A"] = {"wall_s": a["wall_s"], "launches": a["launches"]}
    release_graphs()
    before = launch_counts()
    b = grpc_converge()
    b["launches"] = _launches_since(before)
    for name in ("sinkhorn_u", "sinkhorn_v"):
        if b["launches"][name] <= 0:
            fail(f"grpc: arm B never launched {name}")
    cycles += b["steps"]
    emit({"phase": "grpc", "arm": "B", "cell": "grpc-5k-deltas", **b})
    out["B"] = {"wall_s": b["wall_s"], "launches": b["launches"]}
    release_graphs()
    before = launch_counts()
    runs = {dev: grpc_stream(dev, GRPC["eq_nodes"], GRPC["eq_bound"],
                             GRPC["eq_pending"], GRPC["eq_verb_pods"],
                             full=False)
            for dev in ("cuda", "cpu")}
    launches_c = _launches_since(before)
    if runs["cuda"]["placements"] != runs["cpu"]["placements"]:
        diff = [(a_, b_) for a_, b_ in zip(runs["cuda"]["placements"],
                                          runs["cpu"]["placements"])
                if a_ != b_]
        fail(f"grpc: arm C's placements differ on CUDA and CPU: {diff[:3]}")
    cycles += runs["cuda"]["cycles"]
    emit({"phase": "grpc", "arm": "C", "cell": "grpc-5k-deltas",
          "equal_placements": len(runs["cuda"]["placements"]),
          "launches": launches_c,
          **{f"{dev}_{k}": runs[dev][k] for dev in runs
             for k in ("wall_s", "cycle_s", "transport")}})
    out["C"] = {"wall_s": runs["cuda"]["wall_s"] + runs["cpu"]["wall_s"],
                "launches": launches_c}
    return {"launches": launch_counts(), "shapes": launch_shapes(),
            "cycles": cycles, "arms": out}


# ---------------------------------------------------------------------------
# phase 18: the node-axis mesh on one card
# ---------------------------------------------------------------------------

#: the mesh phase's sizes: arm A the smoke cell at full width, arm B
#: ``sparse-5k-churn``'s cluster with a 1024 burst and 8 steady cycles (and
#: at 500 nodes on the card and on CPU tensors), arm C one ladder cycle of
#: 1024 pods, arm D the smoke cluster under 256-pod cycles and a composed
#: serving churn on a 2-shard mesh
MESH = {"n_nodes": 5000, "n_bound": 1000, "n_pending": 10000,
        "shards": 8, "burst": 1024, "steady": 8,
        "eq_nodes": 500, "eq_bound": 100, "eq_burst": 512,
        "ladder_pods": 1024, "chaos_pods": 256, "serve_shards": 2,
        "serve_batches": (3, 5, 8, 2, 6, 5, 4),
        # arm E: the partitioned solve at full width over 2 and 4 shards,
        # and the plan path's 4096 pods over 4
        "e_shards": (2, 4), "e_plan_pods": 4096, "e_plan_shards": 4}

#: arm A's mesh-off twin (the smoke cell, pipelined at the defaults):
#: arm E's pipelined runs compare against it
_TWIN: dict = {}


@contextlib.contextmanager
def logical_devices(n: int):
    """``parallel.mesh`` resolves against ``n`` copies of the one device
    (the card, or the CPU for a CPU scheduler): a logical mesh of ``n``
    shards on it, as the port's tests run 8 on the CPU."""
    import torch

    from kubernetes_tpu_torch.parallel import mesh as pmesh

    real = pmesh.local_devices
    pmesh.local_devices = lambda kind="cuda": [
        torch.device("cpu") if kind == "cpu" else torch.device("cuda", 0)
    ] * n
    try:
        yield
    finally:
        pmesh.local_devices = real


@contextlib.contextmanager
def distinct_card_path():
    """The copies of the one card taken as distinct cards:
    ``Mesh.logical`` reads False and every placement copies, as a copy to
    another card does. So the multi-card code path runs on one card
    (each block uploaded apart, the owning block's delta scatter, the
    Python round loop with one counted read a round), every peer copy a
    copy on the card."""
    from kubernetes_tpu_torch.parallel import mesh as pmesh

    logical, to = pmesh.Mesh.logical, pmesh._to
    pmesh.Mesh.logical = property(lambda self: False)
    pmesh._to = lambda t, dev: None if t is None else t.to(dev).clone()
    try:
        yield
    finally:
        pmesh.Mesh.logical, pmesh._to = logical, to


def _mesh_doc(mesh=None, **doc) -> dict:
    out = {"percentageOfNodesToScore": 100, **doc}
    if mesh is not None:
        out["parallel"] = {"mesh": mesh}
    return out


def _mesh_cycles(sched, pending, sync_error_at=None):
    """Feed ``pending`` and run cycles until the queue is empty; cycle
    ``sync_error_at`` runs under ``torch.cuda.set_sync_debug_mode(
    "error")``. Returns (results, records, wall seconds)."""
    import torch

    for p in pending:
        sched.on_pod_add(p)
    results, records = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(16):
        if not sched.queue.pending_pods()["active"]:
            break
        if k == sync_error_at:
            torch.cuda.set_sync_debug_mode("error")
        try:
            r = sched.schedule_cycle()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        results.append(r)
        records.append(sched.obs.recorder.records()[-1])
    torch.cuda.synchronize()
    return results, records, time.perf_counter() - t0


def mesh_arm_a(tmp: str) -> dict:
    """Arm A: the smoke cell at full width through ``parallel: {mesh:
    auto}`` (a mesh of 1 on one card) beside a mesh-off twin, both
    ``Scheduler.from_config``. Fails unless placements, rounds and host
    syncs are equal cycle for cycle, the pair launched as often on both
    (and at all), the mesh run's batch shapes carry ``+mesh1``, its gauge
    and every flight record's mesh read 1 (the twin's 0), and its second
    cycle ran clean under sync-debug ``error``. ``cycles`` counts both
    runs, as the phase's launch count does."""
    nodes, bound, pending = smoke_cell(MESH["n_nodes"], MESH["n_bound"],
                                       MESH["n_pending"])
    by_key = {p.key(): p for p in pending}
    runs = {}
    for name, mesh in (("off", None), ("auto", "auto")):
        sched = configured(_mesh_doc(mesh), tmp, f"mesh-a-{name}",
                           enable_preemption=False)
        feed(sched, nodes, bound, [])
        before = launch_counts()
        results, records, wall = _mesh_cycles(
            sched, pending, sync_error_at=1 if mesh else None)
        runs[name] = {
            "sched": sched, "results": results, "records": records,
            "wall_s": wall, "launches": _launches_since(before)}
        for r in results:
            if r.solver_tier != "batch" or r.solver_fallbacks:
                fail(f"mesh/A/{name}: a cycle solved on {r.solver_tier!r} "
                     f"after {r.solver_fallbacks} fallbacks")
        release_graphs()
    off, on = runs["off"], runs["auto"]
    _TWIN["pipelined"] = [(r.assignments, r.rounds) for r in off["results"]]
    _TWIN["pipelined_solve_s"] = [r.solve_s for r in off["results"]]
    for key in ("assignments", "rounds", "host_syncs", "snapshot_mode",
                "pipeline_chunks"):
        a = [getattr(r, key) for r in off["results"]]
        b = [getattr(r, key) for r in on["results"]]
        if a != b:
            fail(f"mesh/A: {key} differ from the mesh-off twin's"
                 + ("" if key == "assignments" else f": {b} != {a}"))
    pair = "fused_pair_normalize"
    if not (on["launches"][pair] == off["launches"][pair] > 0):
        fail(f"mesh/A: the pair launched {on['launches'][pair]} times on "
             f"the mesh, {off['launches'][pair]} off it")
    shapes = [rec.batch_shape for rec in on["records"]]
    if not all(s.endswith("+mesh1") for s in shapes):
        fail(f"mesh/A: batch shapes {shapes} lack +mesh1")
    if any("+mesh" in rec.batch_shape for rec in off["records"]):
        fail("mesh/A: the mesh-off twin's batch shape names a mesh")
    gauge = on["sched"].metrics.mesh_devices.value()
    flags = [rec.mesh for rec in on["records"]]
    if (gauge != 1 or flags != [1] * len(flags) or on["sched"].mesh.size != 1
            or off["sched"].metrics.mesh_devices.value() != 0
            or any(rec.mesh for rec in off["records"])):
        fail(f"mesh/A: gauge {gauge}, flight records' mesh {flags}")
    if on["sched"].cache.resident_mesh is not on["sched"].mesh:
        fail("mesh/A: the resident table is not on the mesh")
    placed = {k: v for r in on["results"] for k, v in r.assignments.items()}
    if len(placed) != len(pending):
        fail(f"mesh/A: bound {len(placed)} of {len(pending)}")
    recheck_capacity(nodes, bound, placed, by_key)
    return {"cell": "smoke-5k-prefaffinity", "mesh": 1,
            "pods": len(pending),
            "cycles": len(on["results"]) + len(off["results"]),
            "batch_shapes": shapes, "flight_record_mesh": flags,
            "rounds": [r.rounds for r in on["results"]],
            "host_syncs": [r.host_syncs for r in on["results"]],
            "sync_error_cycle": 1, "wall_s": on["wall_s"],
            "twin_wall_s": off["wall_s"],
            "solve_s": [r.solve_s for r in on["results"]],
            "twin_solve_s": [r.solve_s for r in off["results"]],
            # reported, never gated: the cost model's collective term
            # has no meaning for shards that share one card
            "model_efficiency": [r.model_efficiency for r in on["results"]],
            "twin_model_efficiency": [r.model_efficiency
                                      for r in off["results"]],
            "launches": on["launches"], "twin_launches": off["launches"]}


def mesh_sparse(tmp: str, name: str, solver: str, shards, device="cuda",
                **traffic):
    """``sparse_traffic`` (a burst, then steady cycles) through
    ``Scheduler.from_config`` with ``incremental {enabled, primary,
    candidateBucket: 256}`` (warm potentials at 1e-3 under sinkhorn) and
    ``parallel: {mesh: shards}`` over logical devices. Returns (results,
    the cell, the final pod -> node map, launches, wall seconds)."""
    import random

    doc = _mesh_doc(shards, solver=solver, incremental={
        "enabled": True, "primary": True, "candidateBucket": 256,
        "warmPotentials": True, "warmTol": 1e-3})
    with logical_devices(shards or 1):
        sched = configured(doc, tmp, name, device=device,
                           enable_preemption=False)
    if (shards or 0) != (sched.mesh.size if sched.mesh else 0):
        fail(f"mesh/B: asked for {shards} shards, built "
             f"{sched.mesh and sched.mesh.size}")
    cell = sparse_traffic(**traffic)
    nodes, bound, cycles, _scopes, _misfit = cell
    placed = {}
    for nd in nodes:
        sched.on_node_add(nd)
    for p in bound:
        sched.on_pod_add(p)
        placed[p.key()] = p
    results, walls = [], []
    before = launch_counts()
    _drive_sparse(sched, cycles, placed, random.Random(11), results, walls,
                  device == "cuda")
    launches = _launches_since(before)
    for r in results:
        if r.solver_tier != solver or r.solver_fallbacks:
            fail(f"mesh/B/{name}: a cycle solved on {r.solver_tier!r} after "
                 f"{r.solver_fallbacks} fallbacks")
    if shards and sched.obs.recorder.records()[-1].mesh != shards:
        fail(f"mesh/B/{name}: the flight record's mesh is not {shards}")
    return (results, cell, {k: p.node_name for k, p in placed.items()},
            launches, sum(walls))


def mesh_arm_b(tmp: str) -> dict:
    """Arm B: a logical 8-shard mesh on the card over ``sparse-5k-churn``'s
    cluster (a 1024 burst, then 8 steady cycles), under ``batch`` and
    ``sinkhorn``, beside an unsharded twin: the same scope sequence (the
    traffic's), the same placements (the per-shard candidate pick merges
    to the single pass's), every pod that fits bound once, capacity clean,
    u and v launched under sinkhorn; then the same traffic at 500 nodes
    places equally on the card and on CPU tensors at 8 shards. ``cycles``
    counts every card run's cycles (twins and 500-node runs included), as
    the phase's launch count does."""
    shards = MESH["shards"]
    traffic = dict(n_nodes=MESH["n_nodes"], n_bound=MESH["n_bound"],
                   burst=MESH["burst"], steady=MESH["steady"])
    out = {}
    launches = {k: 0 for k in ARRAY_KERNELS}
    card_cycles = 0
    for solver in ("batch", "sinkhorn"):
        twin, _, twin_final, _, twin_s = mesh_sparse(
            tmp, f"mesh-b-{solver}-off", solver, None, **traffic)
        release_graphs()
        results, cell, final, got, wall = mesh_sparse(
            tmp, f"mesh-b-{solver}", solver, shards, **traffic)
        release_graphs()
        card_cycles += len(twin) + len(results)
        nodes, bound, cycles, want_scopes, _misfit = cell
        scopes = [r.solve_scope for r in results]
        if (scopes != [r.solve_scope for r in twin]
                or not {"restricted", "partitioned"} <= set(scopes)):
            fail(f"mesh/B/{solver}: scopes {scopes} != the twin's "
                 f"{[r.solve_scope for r in twin]}, or a sparse route "
                 "never ran")
        if final != twin_final:
            fail(f"mesh/B/{solver}: placements differ from the twin's")
        pending = [p for _a, ps, _d in cycles for p in ps]
        keys = [k for r in results for k in r.assignments]
        if len(keys) != len(set(keys)) or len(keys) != len(pending) - 1:
            fail(f"mesh/B/{solver}: {len(keys)} binds ({len(set(keys))} "
                 f"pods) of {len(pending) - 1} that fit")
        all_nodes = nodes + [nd for add, _p, _d in cycles for nd in add]
        recheck_capacity(all_nodes, [], final,
                         {p.key(): p for p in bound + pending})
        if got["fused_pair_normalize"] <= 0:
            fail(f"mesh/B/{solver}: the pair never launched")
        if solver == "sinkhorn" and (got["sinkhorn_u"] <= 0
                                     or got["sinkhorn_v"] <= 0):
            fail(f"mesh/B/sinkhorn: u / v not launched ({got})")
        for k in launches:
            launches[k] += got[k]
        out[solver] = {"scopes": scopes, "traffic_scopes": want_scopes,
                       "cycles": len(results),
                       "binds": len(keys), "wall_s": wall,
                       "twin_wall_s": twin_s, "launches": got,
                       "rounds": [r.rounds for r in results],
                       "model_efficiency": [r.model_efficiency
                                            for r in results]}
    eq = dict(n_nodes=MESH["eq_nodes"], n_bound=MESH["eq_bound"],
              burst=MESH["eq_burst"], steady=MESH["steady"])
    for solver in ("batch", "sinkhorn"):
        cuda = mesh_sparse(tmp, f"mesh-b-eq-{solver}", solver, shards, **eq)
        release_graphs()
        cpu = mesh_sparse(tmp, f"mesh-b-eq-{solver}-cpu", solver, shards,
                          device="cpu", **eq)
        if cuda[2] != cpu[2] or [r.solve_scope for r in cuda[0]] != [
                r.solve_scope for r in cpu[0]]:
            fail(f"mesh/B/{solver}: 500-node placements differ on CUDA and "
                 "CPU at 8 shards")
        for k in launches:
            launches[k] += cuda[3][k]
        card_cycles += len(cuda[0])
        out[f"equal_{solver}"] = len(cuda[2])
    out["launches"] = launches
    out["cycles"] = card_cycles
    return out


class _LostThenKernelFault:
    """``solve:batch`` loses its device; the ``batch-single`` rung then
    hits a broken kernel, which must reach the caller."""

    def __init__(self):
        from kubernetes_tpu_torch import faults, kernels

        self.sites = []
        self.lost = faults.DeviceLost
        self.kernel_error = kernels.KernelError

    def solver_hook(self, site, assigned, usage, rounds, n_nodes):
        self.sites.append(site)
        if site == "solve:batch":
            raise self.lost(f"injected device loss at {site}")
        raise self.kernel_error(f"injected kernel fault at {site}")

    def device_hook(self, site):
        return None


def mesh_arm_c(tmp: str) -> dict:
    """Arm C: ``solve:batch`` armed with ``device_lost`` once (retries 0)
    on arm A's cluster under ``parallel: {mesh: auto}``, one cycle of 1024
    pods: the ladder's ``batch-single`` rung places every pod, as a
    fault-free twin, with the pair launched on it; then a rung whose
    kernel fails: the ``KernelError`` reaches the caller (the rung
    swallows none) and ``batch-cpu`` is never tried. ``cycles`` counts
    all three."""
    from kubernetes_tpu_torch import faults, kernels

    nodes, bound, pending = smoke_cell(MESH["n_nodes"], MESH["n_bound"],
                                       MESH["ladder_pods"])
    doc = _mesh_doc("auto", robustness={"solverRetries": 0})
    got = {}
    for name, inj in (("twin", None),
                      ("lost", faults.FaultInjector(seed=0).arm(
                          "solve:batch", "device_lost", count=1))):
        sched = configured(doc, tmp, f"mesh-c-{name}", fault_injector=inj,
                           enable_preemption=False)
        feed(sched, nodes, bound, [])
        before = launch_counts()
        r, wall = _ladder_cycle(sched, pending)
        got[name] = (r, wall, _launches_since(before))
        release_graphs()
    r, wall, launches = got["lost"]
    twin = got["twin"][0]
    if r.solver_tier != "batch-single" or r.solver_fallbacks != 1:
        fail(f"mesh/C: tier {r.solver_tier!r} after {r.solver_fallbacks} "
             "fallbacks, not batch-single after 1")
    if r.scheduled != len(pending) or r.assignments != twin.assignments:
        fail(f"mesh/C: batch-single bound {r.scheduled} of {len(pending)}, "
             "or not as the fault-free twin")
    if launches["fused_pair_normalize"] <= 0:
        fail("mesh/C: the batch-single rung never launched the pair")
    inj = _LostThenKernelFault()
    sched = configured(doc, tmp, "mesh-c-kernel", fault_injector=inj,
                       enable_preemption=False)
    feed(sched, nodes, bound, [])
    try:
        _ladder_cycle(sched, pending[:64])
        fail("mesh/C: a KernelError on the batch-single rung was swallowed")
    except kernels.KernelError:
        pass
    if inj.sites != ["solve:batch", "solve:batch-single"]:
        fail(f"mesh/C: the ladder tried {inj.sites} around a kernel fault")
    release_graphs()
    return {"cell": "smoke-5k-prefaffinity", "pods": len(pending),
            "tier": r.solver_tier, "fallbacks": r.solver_fallbacks,
            "tier_attempts": r.tier_attempts, "cycle_s": wall,
            "twin_cycle_s": got["twin"][1], "launches": launches,
            "kernel_error_sites": inj.sites, "cycles": 3}


def mesh_arm_d(tmp: str) -> dict:
    """Arm D: ``chaos.MeshChaos.lose_shard`` mid-run on a logical 8-shard
    mesh over the smoke cluster (``deviceResetLimit: 1``, a 5 s cooloff on
    a hand-advanced clock, 256-pod cycles): host mode through the
    cooloff, the resident table back on the mesh after it, the flight
    records' mesh 0 in host mode and 8 else, resets equal to the shots
    fired. Then a composed ``ServingRuntime`` on a 2-shard mesh (warmed,
    so with the host-fallback sweep) loses a shard mid-churn: every
    created pod binds exactly once, and no round-loop graph is captured
    and no solve retraced through loss, cooloff and heal."""
    import torch

    from kubernetes_tpu_torch import chaos

    shards = MESH["shards"]
    rec_doc = {"recovery": {"deviceResetLimit": 1, "deviceCooloff": "5s"}}
    nodes, bound, pending = smoke_cell(MESH["n_nodes"], MESH["n_bound"],
                                       6 * MESH["chaos_pods"])
    clk = _Clock()
    with logical_devices(shards):
        sched = configured(_mesh_doc(shards, **rec_doc), tmp, "mesh-d",
                           clock=clk, enable_preemption=False)
    sched.binder = ConfirmingBinder(sched)
    feed(sched, nodes, bound, [])
    ch = chaos.MeshChaos(sched, shard=3)
    # cycle -> seconds the clock moves before it; the shard is lost
    # before cycle 2
    script = (0.0, 1.0, 1.0, 2.0, 6.0, 1.0)
    modes, flags, walls = [], [], []
    before = launch_counts()
    n = MESH["chaos_pods"]
    for k, dt in enumerate(script):
        clk.t += dt
        if k == 2:
            ch.lose_shard(clk())
        for p in pending[k * n:(k + 1) * n]:
            sched.on_pod_add(p)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = sched.schedule_cycle()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        ch.observe(r, clk())
        if r.scheduled != n:
            fail(f"mesh/D: cycle {k} bound {r.scheduled} of {n}")
        modes.append(r.snapshot_mode)
        flags.append(sched.obs.recorder.records()[-1].mesh)
    launches = _launches_since(before)
    rep = ch.report()
    resets = sched.metrics.recovery_device_resets.value()
    if (modes[2:5] != ["host", "host", "full"]
            or "host" in modes[:2] + modes[5:]):
        fail(f"mesh/D: snapshot modes {modes}")
    if flags != [shards, shards, 0, 0, shards, shards]:
        fail(f"mesh/D: flight records' mesh {flags}")
    if not (resets == rep["shard_losses_fired"] == 2
            and rep["healed_sharded"] and rep["host_mode_cycles"] == 2):
        fail(f"mesh/D: resets {resets}, chaos report {rep}")
    resident = sched.cache.resident_mesh
    if resident is None or resident.size != shards:
        fail("mesh/D: the healed resident table is not on the mesh")
    release_graphs()
    serve = mesh_serve_churn(tmp)
    launches = {k: launches[k] + serve["launches"][k] for k in launches}
    return {"cell": "smoke-5k-prefaffinity", "shards": shards,
            "modes": modes, "flight_record_mesh": flags,
            "cycle_s": walls, "chaos": rep, "device_resets": resets,
            "serve": serve, "launches": launches,
            "cycles": len(script) + serve["cycles"]}


def mesh_serve_churn(tmp: str) -> dict:
    """The composed runtime on a logical 2-shard mesh over the smoke
    cluster: warmed (pod buckets 8 and 16; the runtime forces the
    host-fallback sweep), churn batches flushed at once, a shard lost
    after the fourth, the cooloff's host-mode cycle, the sharded heal."""
    import torch

    from kubernetes_tpu_torch import chaos
    from kubernetes_tpu_torch.config import ServingConfig
    from kubernetes_tpu_torch.ops import device_loop
    from kubernetes_tpu_torch.serving import ServingRuntime
    from kubernetes_tpu_torch.testing import make_pod

    shards = MESH["serve_shards"]
    clk = _Clock()
    doc = _mesh_doc(shards, recovery={"deviceResetLimit": 1,
                                      "deviceCooloff": "5s"},
                    warmup={"enabled": True, "podBuckets": [8, 16]})
    with logical_devices(shards):
        sched = configured(doc, tmp, "mesh-d-serve", clock=clk,
                           enable_preemption=False)
    truth: dict = {}
    doubles = [0]

    class CasBinder:
        def bind(self, pod, node_name):
            if pod.key() in truth:
                doubles[0] += 1
                raise RuntimeError(f"{pod.key()} bound twice")
            truth[pod.key()] = node_name

    sched.binder = CasBinder()
    nodes, bound, _ = smoke_cell(MESH["n_nodes"], MESH["n_bound"], 0)
    feed(sched, nodes, bound, [])
    rt = ServingRuntime(sched, ServingConfig(
        enabled=True, min_wait_s=0.0, max_wait_s=0.0, target_bucket=16,
        idle_wait_s=0.05), clock=clk)
    if not sched.warmup_config.host_fallback:
        fail("mesh/D: the composed runtime did not force the host-fallback "
             "warmup under a mesh")
    c0 = device_loop.CAPTURES.count
    warmed = rt.warm_if_pending(sample_pods=[make_pod(
        "warm", cpu_milli=100, memory=500 * 2**20)])
    torch.cuda.synchronize()
    warm_captures = device_loop.CAPTURES.count - c0
    c1 = device_loop.CAPTURES.count
    ch = chaos.MeshChaos(sched, shard=1)
    created, arc, walls = [], [], []
    before = launch_counts()
    seq = 0
    for k, n in enumerate(MESH["serve_batches"]):
        if k == 4:
            ch.lose_shard(clk())
        if k == 5:
            clk.t += 6.0  # past the cooloff: the heal probe
        for _ in range(n):
            p = make_pod(f"mesh-serve-{seq}", cpu_milli=100,
                         memory=500 * 2**20)
            seq += 1
            created.append(p.key())
            rt.loop.ingest(sched.on_pod_add, p)
        t0 = time.perf_counter()
        r = rt.loop.run_once()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if r is None or r.scheduled != n:
            fail(f"mesh/D/serve: batch {k} bound "
                 f"{None if r is None else r.scheduled} of {n}")
        ch.observe(r, clk())
        arc.append((r.snapshot_mode, sched.obs.recorder.records()[-1].mesh))
        clk.t += 0.25
    captures = device_loop.CAPTURES.count - c1
    launches = _launches_since(before)
    rep = ch.report()
    if doubles[0] or sorted(truth) != sorted(created):
        fail(f"mesh/D/serve: {doubles[0]} double binds, {len(truth)} of "
             f"{len(created)} pods bound")
    if [m for m, _ in arc][4:6] != ["host", "full"] or [
            f for _, f in arc] != [shards] * 4 + [0] + [shards] * 2:
        fail(f"mesh/D/serve: the arc's modes and mesh flags {arc}")
    if not rep["healed_sharded"] or rep["host_mode_cycles"] != 1:
        fail(f"mesh/D/serve: chaos report {rep}")
    retraces = sched.obs.jax.retrace_total()
    if captures or retraces or not warm_captures:
        fail(f"mesh/D/serve: {captures} graph captures and {retraces} "
             f"retraces after warmup ({warm_captures} in it)")
    release_graphs()
    return {"shards": shards, "warmed": warmed,
            "warm_captures": warm_captures, "captures_after_warmup":
            captures, "retraces": retraces, "arc": arc, "chaos": rep,
            "binds": len(truth), "cycle_s": walls, "launches": launches,
            "cycles": len(arc)}


def _collectives_beside_model(shards: int, P: int, N: int) -> dict:
    """The collectives of the last partitioned round body the host ran
    (``parallel/collectives.ROUND``: calls, payload bytes a mesh over
    cards moves, bytes this run moved) beside the cost model's payloads
    for one round at the same (d, P, N)."""
    from kubernetes_tpu_torch.parallel import collectives as coll
    from kubernetes_tpu_torch.parallel.costmodel import CollectiveCostModel

    model = CollectiveCostModel(devices=shards, pods_per_batch=P,
                                nodes_padded=N).per_round_collectives()
    return {"round": coll.ROUND.snapshot(), "solve": coll.STATS.snapshot(),
            "model_per_round": model}


def mesh_arm_e(tmp: str) -> dict:
    """Arm E: the partitioned solve at full width on the card. The smoke
    cell (5000 nodes over 10 zones, 1000 bound, 10,000 pending pods) runs
    through ``Scheduler.from_config`` with ``parallel.mesh`` over 2 and 4
    copies of the card, monolithic (``pipelineDepth: 1``: batches of 8192
    and 1808) beside a mesh-off monolithic twin, and pipelined (the
    defaults) beside arm A's mesh-off twin. Fails unless placements and
    rounds equal the twin's cycle for cycle, every cycle solved on the
    configured tier, the second cycle ran clean under sync-debug
    ``error``, the split pair launched on every run and every batch
    shape carries ``+mesh{d}``. Then ``solver: sinkhorn`` with 4096
    pending pods on 4 shards beside its mesh-off twin: equal placements
    and rounds, u (split) and v launched. The collectives of a round
    body are reported beside the cost model's payloads."""
    nodes, bound, pending = smoke_cell(MESH["n_nodes"], MESH["n_bound"],
                                       MESH["n_pending"])
    by_key = {p.key(): p for p in pending}
    out = {"cell": "smoke-5k-prefaffinity", "runs": {}}
    launches = {k: 0 for k in ARRAY_KERNELS + SPLIT_KERNELS}
    cycles = 0

    def run(name, doc, shards, pods, sync_error_at=None):
        nonlocal cycles
        from kubernetes_tpu_torch.parallel import collectives as coll

        with logical_devices(shards or 1):
            sched = configured(_mesh_doc(shards, **doc), tmp,
                               f"mesh-e-{name}", enable_preemption=False)
        feed(sched, nodes, bound, [])
        before = launch_counts()
        coll.STATS.reset()
        results, records, wall = _mesh_cycles(sched, pods, sync_error_at)
        got = _launches_since(before)
        loops = launch_counts()["round_loop"] - before["round_loop"]
        for k in launches:
            launches[k] += got[k]
        cycles += len(results)
        tier = doc.get("solver", "batch")
        for r in results:
            if r.solver_tier != tier or r.solver_fallbacks:
                fail(f"mesh/E/{name}: a cycle solved on {r.solver_tier!r} "
                     f"after {r.solver_fallbacks} fallbacks")
        if shards and not all(rec.batch_shape.endswith(f"+mesh{shards}")
                              for rec in records):
            fail(f"mesh/E/{name}: batch shapes "
                 f"{[rec.batch_shape for rec in records]}")
        P = max((int(rec.batch_shape.split("xN")[0][1:]) for rec in records),
                default=0)
        coll_now = (_collectives_beside_model(shards, P, 8192)
                    if shards else None)
        release_graphs()
        return {"results": results, "wall_s": wall, "launches": got,
                "round_loops": loops, "collectives": coll_now,
                "solve_s": [r.solve_s for r in results],
                "rounds": [r.rounds for r in results],
                "host_syncs": [r.host_syncs for r in results]}

    mono = {"pipelineDepth": 1}
    twins = {"monolithic": run("mono-off", mono, None, pending)}
    twin_pairs = {"monolithic": [(r.assignments, r.rounds) for r in
                                 twins["monolithic"]["results"]],
                  "pipelined": _TWIN.get("pipelined")}
    if twin_pairs["pipelined"] is None:
        twins["pipelined"] = run("pipe-off", {}, None, pending)
        twin_pairs["pipelined"] = [(r.assignments, r.rounds) for r in
                                   twins["pipelined"]["results"]]
    for mode, doc in (("monolithic", mono), ("pipelined", {})):
        for d in MESH["e_shards"]:
            got = run(f"{mode}-{d}", doc, d, pending, sync_error_at=1)
            pairs = [(r.assignments, r.rounds) for r in got["results"]]
            if pairs != twin_pairs[mode]:
                fail(f"mesh/E/{mode}/{d}: placements or rounds differ from "
                     "the mesh-off twin's: rounds "
                     f"{[p[1] for p in pairs]} against "
                     f"{[p[1] for p in twin_pairs[mode]]}")
            for k in ("fused_pair_max", "fused_pair_scale"):
                if got["launches"][k] <= 0:
                    fail(f"mesh/E/{mode}/{d}: {k} never launched")
            if got["launches"]["fused_pair_normalize"]:
                fail(f"mesh/E/{mode}/{d}: the fused pair ran on the mesh")
            placed = {k: v for r in got["results"]
                      for k, v in r.assignments.items()}
            if len(placed) != len(pending):
                fail(f"mesh/E/{mode}/{d}: bound {len(placed)} of "
                     f"{len(pending)}")
            recheck_capacity(nodes, bound, placed, by_key)
            got.pop("results")
            out["runs"][f"{mode}-{d}"] = got
    # the multi-card code path on one card, beside the monolithic twin:
    # the same placements, no round-loop graph (one cannot span cards),
    # one counted read a round more than the twin
    with distinct_card_path():
        got = run("cards-path-2", mono, 2, pending, sync_error_at=1)
    pairs = [(r.assignments, r.rounds) for r in got.pop("results")]
    if pairs != twin_pairs["monolithic"]:
        fail("mesh/E/cards-path: placements or rounds differ from the "
             "mesh-off twin's")
    if got["round_loops"] or got["launches"]["fused_pair_max"] <= 0:
        fail(f"mesh/E/cards-path: {got['round_loops']} round-loop graphs "
             f"launched, the split pair {got['launches']['fused_pair_max']}"
             " times")
    want_syncs = [a + r + 1 for a, r in zip(
        twins["monolithic"]["host_syncs"], twins["monolithic"]["rounds"])]
    if got["host_syncs"] != want_syncs:
        fail(f"mesh/E/cards-path: host syncs {got['host_syncs']}, "
             f"expected the twin's plus rounds + 1: {want_syncs}")
    out["runs"]["cards-path-2"] = got
    for mode, t in twins.items():
        t.pop("results")
        out["runs"][f"{mode}-off"] = t
    if "pipelined" not in twins:
        out["runs"]["pipelined-off"] = {
            "solve_s": _TWIN.get("pipelined_solve_s"),
            "rounds": [p[1] for p in twin_pairs["pipelined"]],
            "note": "arm A's mesh-off twin"}
    plan = pending[:MESH["e_plan_pods"]]
    d = MESH["e_plan_shards"]
    twin = run("sinkhorn-off", {"solver": "sinkhorn"}, None, plan)
    got = run(f"sinkhorn-{d}", {"solver": "sinkhorn"}, d, plan,
              sync_error_at=1)
    pairs = [(r.assignments, r.rounds) for r in got.pop("results")]
    want = [(r.assignments, r.rounds) for r in twin.pop("results")]
    if pairs != want:
        diff = sum(a.get(k) != v for (a, _), (b, _) in zip(pairs, want)
                   for k, v in b.items())
        fail(f"mesh/E/sinkhorn/{d}: placements or rounds differ from the "
             f"mesh-off twin's ({diff} pods placed elsewhere)")
    if got["launches"]["sinkhorn_u_partial"] <= 0 or \
            got["launches"]["sinkhorn_v"] <= 0:
        fail(f"mesh/E/sinkhorn/{d}: u / v not launched ({got['launches']})")
    if got["launches"]["sinkhorn_u"]:
        fail(f"mesh/E/sinkhorn/{d}: the whole-row u pass ran on the mesh")
    out["runs"][f"sinkhorn-{d}"] = got
    out["runs"]["sinkhorn-off"] = twin
    out["launches"] = launches
    out["cycles"] = cycles
    return out


def mesh_arm_e2(tmp: str) -> dict:
    """Arm E2: ``parallel: {mesh: auto}`` over every card of the machine,
    beside a one-card twin, with equal placements required. Runs only
    where ``torch.cuda.device_count() >= 2``; otherwise it says on its own
    line that it did not run, and why."""
    import torch

    count = torch.cuda.device_count()
    if count < 2:
        print(f"chip_smoke: mesh arm E2 did not run: "
              f"torch.cuda.device_count() is {count}, the arm needs two "
              "or more cards", flush=True)
        return {"ran": False, "device_count": count, "cycles": 0,
                "launches": {k: 0 for k in ARRAY_KERNELS + SPLIT_KERNELS}}
    nodes, bound, pending = smoke_cell(MESH["n_nodes"], MESH["n_bound"],
                                       MESH["ladder_pods"])
    got = {}
    for name, mesh in (("one", None), ("auto", "auto")):
        sched = configured(_mesh_doc(mesh), tmp, f"mesh-e2-{name}",
                           enable_preemption=False)
        feed(sched, nodes, bound, [])
        before = launch_counts()
        results, _records, wall = _mesh_cycles(sched, pending)
        got[name] = ([(r.assignments, r.rounds) for r in results], wall,
                     _launches_since(before), sched.mesh)
        release_graphs()
    if got["auto"][0] != got["one"][0]:
        fail(f"mesh/E2: placements over {count} cards differ from one "
             "card's")
    return {"ran": True, "device_count": count,
            "mesh": [str(d) for d in got["auto"][3].devices],
            "wall_s": got["auto"][1], "twin_wall_s": got["one"][1],
            "launches": got["auto"][2], "cycles": len(got["auto"][0])}


def phase_mesh() -> dict:
    """The node-axis mesh on one card (cell ``mesh``): arms A-D, every
    scheduler a JSON v1alpha1 file through ``Scheduler.from_config``, all
    counted from 0 together: the launches are every card run's of the
    phase (the twins, the 500-node runs and the composed runtime's warmup
    included), and ``cycles`` counts every cycle of those runs. Injects
    shard losses (arm D) and a solve-site device loss (arm C), so, as
    ``recovery``, it may reset the device."""
    import tempfile

    from kubernetes_tpu_torch import kernels

    kernels.reset_launches()
    t_arm = {}
    cycles = 0
    with tempfile.TemporaryDirectory() as tmp:
        for arm, run in (("A", mesh_arm_a), ("B", mesh_arm_b),
                         ("C", mesh_arm_c), ("D", mesh_arm_d),
                         ("E", mesh_arm_e), ("E2", mesh_arm_e2)):
            t0 = time.perf_counter()
            got = run(tmp)
            t_arm[arm] = time.perf_counter() - t0
            cycles += got["cycles"]
            emit({"phase": "mesh", "arm": arm, "arm_s": t_arm[arm], **got})
    return {"launches": launch_counts(), "shapes": launch_shapes(),
            "cycles": cycles, "arm_s": t_arm}


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def _kernel_name(mangled: str) -> str:
    """The kernel's identifier inside a mangled name, with its template
    arguments (``v_kernel<1,0>`` for ``...8v_kernelILb1ELb0EE...``)."""
    import re

    for m in re.finditer(r"(?=(\d+)([A-Za-z_]\w*))", mangled):
        size = int(m.group(1))
        ident = m.group(2)[:size]
        if len(ident) == size and ident.endswith("kernel"):
            t = re.match(r"I((?:Lb\dE)+)E", m.group(2)[size:])
            args = re.findall(r"Lb(\d)E", t.group(1)) if t else []
            return ident + (f"<{','.join(args)}>" if args else "")
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


def debug_get(sched, path: str):
    """GET ``path`` from the port's server over a scheduler, on
    127.0.0.1: ``(status, JSON body)``."""
    import http.client

    from kubernetes_tpu_torch.server import serve_scheduler

    srv = serve_scheduler(sched, host="127.0.0.1", port=0)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                          timeout=30)
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
        conn.close()
    finally:
        srv.shutdown()
        srv.server_close()
    return resp.status, json.loads(body)


def release_graphs() -> None:
    """Drop the cached round-loop graphs of the phase that ended and give
    their memory back (each graph keeps its round's temporaries)."""
    import torch

    from kubernetes_tpu_torch.ops import device_loop

    torch.cuda.synchronize()
    device_loop.clear()
    torch.cuda.empty_cache()


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
    script_t0 = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of: "
                         + ", ".join(ALL_PHASES))
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
    from kubernetes_tpu_torch.scheduler import RECOVERY

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
        t0 = time.perf_counter()
        check_kernels(rows)
        t_split = time.perf_counter()
        check_split_kernels(rows)
        t1 = time.perf_counter()
        emit({"phase": "kernels", "ok": True, "seconds": t1 - t0,
              "split_s": t1 - t_split})

    paths = {}
    phase_s = {}
    for phase, run in (("smoke", lambda: phase_cell("smoke")),
                       ("route", phase_route),
                       ("plan", phase_plan),
                       ("topology", lambda: phase_cell("topology")),
                       ("parity", phase_parity),
                       ("preempt", phase_preempt),
                       ("sparse", phase_sparse),
                       ("pipeline", phase_pipeline),
                       ("config", phase_config),
                       ("serve", phase_serve),
                       ("hollow", phase_hollow),
                       ("recovery", phase_recovery),
                       ("ledger", phase_ledger),
                       ("scenario", phase_scenario),
                       ("grpc", phase_grpc),
                       ("mesh", phase_mesh)):
        if phase not in phases:
            continue
        RECOVERY.reset()
        t_phase = time.perf_counter()
        got = run()
        phase_s[phase] = time.perf_counter() - t_phase
        if phase not in FAULT_PHASES and (RECOVERY.device_resets
                                          or RECOVERY.host_cycles):
            # only the fault phases inject device faults: anywhere else
            # a reset or a host-mode cycle is a real fault passing as a
            # quiet fallback
            fail(f"{phase}: {RECOVERY.device_resets} device resets, "
                 f"{RECOVERY.host_cycles} host-mode cycles")
        if phase in MAIN_PATHS:
            paths[phase] = got
        release_graphs()
    if args.profile:
        for phase in CELLS:
            profile_cycle(args.profile, phase)
    if "kernels" in phases:
        t0 = time.perf_counter()
        time_main_shapes(rows, paths)
        phase_s["main_shapes"] = time.perf_counter() - t0
        if "pipeline" in paths:
            check_round_loop(rows, paths["pipeline"]["inputs"])
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
    emit({"phase": "total", "seconds": time.perf_counter() - script_t0,
          "kernel_build_s": build_s, "phase_seconds": phase_s})
    emit({"kernels": out})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
