"""Executable entry point — the analog of ``cmd/kube-scheduler``
(``scheduler.go:33`` main → ``app/server.go:65`` NewSchedulerCommand →
``:161`` Run): flags → ComponentConfig file decode → validation → healthz/
metrics server → leader election → the scheduling loop (the port of
``kubernetes_tpu/cli.py``).

    python -m kubernetes_tpu_torch --config scheduler.json [--device cpu]
    python -m kubernetes_tpu_torch --validate-only --config scheduler.json

The config file is the ``KubeSchedulerConfiguration`` in JSON or YAML
(apis/config/types.go:43 field meanings) in one of two formats:
``apiVersion: kubescheduler.config.k8s.io/v1alpha1``-tagged files use
the VERSIONED wire spelling (camelCase keys, duration strings, v1alpha1
defaulting — decoded through the api.scheme pipeline); untagged files
use this implementation's native snake_case spelling. A JSON file needs
no YAML parser; only text that is not JSON is handed to ``yaml``. Flags
override file values the way the reference's options layer overlays the
decoded object (app/options/options.go). Invalid configs are rejected
with field-path errors like ``apis/config/validation`` does, and a
configuration that turns on something the port does not have yet is
refused by :func:`unported_features` (it names the ROADMAP item).
``robustness.watchProgressDeadline`` is honoured: every ``sim.Reflector``
built on the configured scheduler takes it as its progress deadline.

Without ``--validate-only``, :func:`main` runs :func:`run`: the HTTP
server, the elector on ``--lock-file`` (or in memory), then either the
serving runtime (``serving.enabled``: doorbell, micro-batch window, APF
shedding) or the legacy fixed-interval loop, until SIGTERM/SIGINT. The
scheduler runs on the card (``--device cuda``, the default; without a
card the process exits non-zero naming it) unless ``--device cpu`` asks
for the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import signal
import sys
from typing import List, Optional

from kubernetes_tpu_torch.config import (
    DEFAULT_FEATURE_GATES,
    FeatureGates,
    IncidentsConfig,
    IncrementalConfig,
    JourneysConfig,
    KubeSchedulerConfiguration,
    LeaderElectionConfig,
    LedgerConfig,
    MemoryLedgerConfig,
    ObservabilityConfig,
    ParallelConfig,
    RecoveryConfig,
    RobustnessConfig,
    ScenarioConfig,
    ServingConfig,
    WarmupConfig,
    load_policy,
)
from kubernetes_tpu_torch.scenarios.packs import SCENARIO_REGISTRY

VALID_SOLVERS = ("batch", "greedy", "exact", "sinkhorn")


#: component-base leader-election jitter factor (leaderelection.go:56) —
#: renewDeadline must exceed retryPeriod * JitterFactor
JITTER_FACTOR = 1.2


class ConfigError(ValueError):
    """Decode/validation failure; ``errors`` lists field-path messages."""

    def __init__(self, errors: List[str]):
        super().__init__("; ".join(errors))
        self.errors = errors


def validate_config(cfg: KubeSchedulerConfiguration) -> List[str]:
    """ValidateKubeSchedulerConfiguration (apis/config/validation/
    validation.go:27) plus checks for this implementation's solver block.
    Returns field-path error strings; empty = valid."""
    errs: List[str] = []
    if not cfg.scheduler_name:
        errs.append("schedulerName: Required value")
    if not 0 <= cfg.hard_pod_affinity_symmetric_weight <= 100:
        errs.append(
            f"hardPodAffinitySymmetricWeight: Invalid value "
            f"{cfg.hard_pod_affinity_symmetric_weight}: not in valid range 0-100"
        )
    if not 0 <= cfg.percentage_of_nodes_to_score <= 100:
        errs.append(
            f"percentageOfNodesToScore: Invalid value "
            f"{cfg.percentage_of_nodes_to_score}: not in valid range 0-100"
        )
    if cfg.bind_timeout_seconds is None or cfg.bind_timeout_seconds < 0:
        errs.append("bindTimeoutSeconds: Required value")
    le = cfg.leader_election
    if le.leader_elect:  # validated only when enabled (validation.go:57-59)
        if le.lease_duration_s <= 0:
            errs.append("leaderElection.leaseDuration: must be greater than zero")
        if le.renew_deadline_s <= 0:
            errs.append("leaderElection.renewDeadline: must be greater than zero")
        if le.retry_period_s <= 0:
            errs.append("leaderElection.retryPeriod: must be greater than zero")
        if le.lease_duration_s <= le.renew_deadline_s:
            errs.append(
                "leaderElection.leaseDuration: must be greater than renewDeadline"
            )
        if le.renew_deadline_s <= JITTER_FACTOR * le.retry_period_s:
            errs.append(
                "leaderElection.renewDeadline: must be greater than "
                f"retryPeriod*JitterFactor ({JITTER_FACTOR})"
            )
        if not le.lock_object_namespace:
            errs.append("leaderElection.lockObjectNamespace: Required value")
        if not le.lock_object_name:
            errs.append("leaderElection.lockObjectName: Required value")
    # solver block (no reference analog; this implementation's tuning)
    if cfg.solver not in VALID_SOLVERS:
        errs.append(
            f"solver: Unsupported value {cfg.solver!r}: "
            f"supported values: {', '.join(VALID_SOLVERS)}"
        )
    if cfg.per_node_cap < 1:
        errs.append("perNodeCap: must be at least 1")
    if cfg.max_rounds < 1:
        errs.append("maxRounds: must be at least 1")
    if cfg.max_batch < 1:
        errs.append("maxBatch: must be at least 1")
    if cfg.pipeline_depth < 1:
        errs.append("pipelineDepth: must be at least 1")
    if cfg.pipeline_chunk < 1:
        errs.append("pipelineChunk: must be at least 1")
    if not 0 <= cfg.snapshot_max_dirty_frac <= 1:
        errs.append(
            f"snapshotMaxDirtyFrac: Invalid value "
            f"{cfg.snapshot_max_dirty_frac}: not in valid range 0-1"
        )
    wu = cfg.warmup
    if wu.min_bucket < 1:
        errs.append("warmup.minBucket: must be at least 1")
    if any(b < 1 for b in wu.pod_buckets):
        errs.append("warmup.podBuckets: buckets must be at least 1")
    inc = cfg.incremental
    if inc.candidate_bucket < 1:
        errs.append("incremental.candidateBucket: must be at least 1")
    if not 0 < inc.max_batch_frac <= 1:
        errs.append(
            f"incremental.maxBatchFrac: Invalid value {inc.max_batch_frac}: "
            "not in valid range (0, 1]"
        )
    if not 0 <= inc.max_dirty_frac <= 1:
        errs.append(
            f"incremental.maxDirtyFrac: Invalid value {inc.max_dirty_frac}: "
            "not in valid range 0-1"
        )
    if inc.warm_tol <= 0:
        errs.append("incremental.warmTol: must be greater than zero")
    if inc.quality_delta < 0:
        errs.append("incremental.qualityDelta: must be non-negative")
    if inc.cold_blocks < 0:
        errs.append("incremental.coldBlocks: must be non-negative "
                    "(0 selects the automatic block count)")
    if not 0 < inc.group_quota_frac <= 1:
        errs.append(
            f"incremental.groupQuotaFrac: Invalid value "
            f"{inc.group_quota_frac}: not in valid range (0, 1]")
    if inc.primary and not inc.enabled:
        errs.append("incremental.primary: requires incremental.enabled "
                    "(the sparsity-first route rides the score cache)")
    rc = cfg.robustness
    if rc.cycle_deadline_s < 0:
        errs.append("robustness.cycleDeadlineSeconds: must be non-negative")
    if rc.solver_retries < 0 or rc.transport_retries < 0:
        errs.append("robustness.retries: must be non-negative")
    if rc.retry_backoff_base_s < 0 or rc.retry_backoff_max_s < 0:
        errs.append("robustness.retryBackoff: must be non-negative")
    if not 0 <= rc.retry_jitter <= 1:
        errs.append(
            f"robustness.retryJitter: Invalid value {rc.retry_jitter}: "
            "not in valid range 0-1"
        )
    if rc.bind_verify_retries < 0:
        errs.append("robustness.bindVerifyRetries: must be non-negative")
    if rc.watch_progress_deadline_s < 0:
        errs.append("robustness.watchProgressDeadline: must be "
                    "non-negative (0 = stall detection off)")
    if rc.breaker_failure_threshold < 1:
        errs.append("robustness.breakerFailureThreshold: must be at least 1")
    if rc.breaker_half_open_probes < 1:
        errs.append("robustness.breakerHalfOpenProbes: must be at least 1")
    bad_tiers = [t for t in rc.fallback_chain
                 if t not in VALID_SOLVERS + ("batch-cpu",)]
    if bad_tiers:
        errs.append(
            f"robustness.fallbackChain: unsupported tier(s) {bad_tiers}: "
            f"supported: {', '.join(VALID_SOLVERS + ('batch-cpu',))}"
        )
    rv = cfg.recovery
    if rv.device_reset_limit < 0:
        errs.append("recovery.deviceResetLimit: must be non-negative")
    if rv.device_cooloff_s < 0:
        errs.append("recovery.deviceCooloff: must be non-negative")
    oc = cfg.observability
    if oc.trace_threshold_s < 0:
        errs.append("observability.traceThreshold: must be non-negative")
    if not 0 <= oc.trace_sampling <= 1:
        errs.append(
            f"observability.traceSampling: Invalid value {oc.trace_sampling}: "
            "not in valid range 0-1"
        )
    if oc.recorder_capacity < 1:
        errs.append("observability.recorderCapacity: must be at least 1")
    if oc.trace_ring_capacity < 1:
        errs.append("observability.traceRingCapacity: must be at least 1")
    if oc.retrace_storm_threshold < 1:
        errs.append("observability.retraceStormThreshold: must be at least 1")
    if oc.retrace_storm_window < 1:
        errs.append("observability.retraceStormWindow: must be at least 1")
    if oc.explain_top_k < 1:
        errs.append("observability.explainTopK: must be at least 1")
    if oc.audit_interval_s < 0:
        errs.append("observability.auditInterval: must be non-negative "
                    "(0 = the serving runtime's auditor off)")
    lg = oc.ledger
    if lg.history < 1:
        errs.append("observability.ledger.history: must be at least 1")
    if lg.dist_window < 1:
        errs.append("observability.ledger.distWindow: must be at least 1")
    if not 0 < lg.baseline_decay <= 1:
        errs.append(
            f"observability.ledger.baselineDecay: Invalid value "
            f"{lg.baseline_decay}: not in valid range (0, 1]")
    if lg.e2e_p99_objective_s < 0:
        errs.append(
            "observability.ledger.e2eP99Objective: must be non-negative "
            "(0 = objective off)")
    if lg.cost_drift_ratio < 0:
        errs.append(
            "observability.ledger.costDriftRatio: must be non-negative "
            "(0 = objective off)")
    if lg.fast_window_s <= 0:
        errs.append(
            "observability.ledger.fastWindow: must be greater than zero")
    if lg.slow_window_s < lg.fast_window_s:
        errs.append(
            "observability.ledger.slowWindow: must be at least fastWindow")
    if lg.burn_threshold <= 0:
        errs.append(
            "observability.ledger.burnThreshold: must be greater than zero")
    mlg = oc.memory_ledger
    if mlg.sample_interval_s < 0:
        errs.append(
            "observability.memoryLedger.sampleInterval: must be "
            "non-negative (0 = sample every cycle boundary)")
    if not 0 < mlg.headroom_frac <= 1:
        errs.append(
            f"observability.memoryLedger.headroomFrac: Invalid value "
            f"{mlg.headroom_frac}: not in valid range (0, 1]")
    if mlg.limit_bytes < 0:
        errs.append(
            "observability.memoryLedger.limitBytes: must be non-negative "
            "(0 = use the device-reported limit)")
    if mlg.history < 1:
        errs.append(
            "observability.memoryLedger.history: must be at least 1")
    if mlg.census_limit < 1:
        errs.append(
            "observability.memoryLedger.censusLimit: must be at least 1")
    jc = oc.journeys
    if jc.slow_k < 1:
        errs.append("observability.journeys.slowK: must be at least 1")
    if jc.sample_every < 0:
        errs.append(
            "observability.journeys.sampleEvery: must be non-negative "
            "(0 = completion sampling off)")
    if jc.window_s <= 0:
        errs.append(
            "observability.journeys.window: must be greater than zero")
    if jc.max_pending < 1:
        errs.append(
            "observability.journeys.maxPending: must be at least 1")
    if jc.max_events < 2:
        errs.append(
            "observability.journeys.maxEvents: must be at least 2")
    ic = oc.incidents
    if ic.capacity < 1:
        errs.append("observability.incidents.capacity: must be at least 1")
    if ic.flight_window < 0:
        errs.append(
            "observability.incidents.flightWindow: must be non-negative")
    if ic.journeys_k < 0:
        errs.append(
            "observability.incidents.journeysK: must be non-negative")
    if ic.cooldown_cycles < 0:
        errs.append(
            "observability.incidents.cooldownCycles: must be non-negative")
    if ic.fallback_burst_threshold < 0:
        errs.append(
            "observability.incidents.fallbackBurstThreshold: must be "
            "non-negative (0 = trigger off)")
    if ic.profile_cycles < 0:
        errs.append(
            "observability.incidents.profileCycles: must be non-negative "
            "(0 = incident-armed profiling off)")
    if ic.max_profiles < 0:
        errs.append(
            "observability.incidents.maxProfiles: must be non-negative")
    ls = oc.lock_sanitizer
    if ls.hold_budget_s < 0:
        errs.append(
            "observability.lockSanitizer.holdBudget: must be non-negative "
            "(0 = hold check off)")
    if ls.max_findings < 1:
        errs.append(
            "observability.lockSanitizer.maxFindings: must be at least 1")
    sc = cfg.serving
    if sc.min_wait_s < 0:
        errs.append("serving.minWait: must be non-negative")
    if sc.max_wait_s < sc.min_wait_s:
        errs.append("serving.maxWait: must be at least minWait")
    if sc.target_bucket < 1:
        errs.append("serving.targetBucket: must be at least 1")
    if sc.idle_wait_s <= 0:
        errs.append("serving.idleWait: must be greater than zero")
    if sc.flow_concurrency < 1:
        errs.append("serving.flowConcurrency: must be at least 1")
    if sc.watch_concurrency < 1:
        errs.append("serving.watchConcurrency: must be at least 1")
    if sc.flow_queue_length < 0:
        errs.append("serving.flowQueueLength: must be non-negative")
    if sc.queue_timeout_s < 0:
        errs.append("serving.queueTimeout: must be non-negative")
    if sc.retry_after_s <= 0:
        errs.append("serving.retryAfter: must be greater than zero")
    if sc.watch_buffer < 1:
        errs.append("serving.watchBuffer: must be at least 1")
    if sc.shed_queue_bound < 0:
        errs.append("serving.shedQueueBound: must be non-negative "
                    "(0 = auto: twice the accumulation target)")
    if sc.degraded_pressure_factor < 1:
        errs.append("serving.degradedPressureFactor: must be at least 1")
    pl = cfg.parallel
    mesh = pl.mesh
    if isinstance(mesh, bool) or not (
            mesh in ("off", "auto")
            or (isinstance(mesh, int) and mesh >= 1)):
        errs.append(
            f"parallel.mesh: Unsupported value {mesh!r}: supported "
            "values: 'off', 'auto', or a positive device count")
    elif isinstance(mesh, int) and mesh & (mesh - 1):
        # the node axis pads to power-of-two buckets and a divisor of a
        # power of two is a power of two — any other count can never
        # divide a bucket and would fail as an opaque XLA shape error
        # mid-solve (make_mesh's runtime fallback covers odd DISCOVERED
        # device sets; a declared count is rejected up front)
        errs.append(
            f"parallel.mesh: Invalid value {mesh}: a device count must "
            "divide the power-of-two node buckets — use a power of two")
    sn = cfg.scenario
    if sn.pack:
        if sn.pack not in SCENARIO_REGISTRY:
            errs.append(
                f"scenario.pack: Unsupported value {sn.pack!r}: "
                f"supported values: '', "
                f"{', '.join(sorted(SCENARIO_REGISTRY))}")
    if sn.cost_weight < 0:
        errs.append("scenario.costWeight: must be non-negative")
    if sn.fill_block < 1:
        errs.append("scenario.fillBlock: must be at least 1")
    if sn.cascade_max_pods < 1:
        errs.append("scenario.cascadeMaxPods: must be at least 1")
    if sn.superpod < 1:
        errs.append("scenario.superpod: must be at least 1")
    if sn.repack_interval_s < 0:
        errs.append("scenario.repackInterval: must be non-negative")
    if sn.repack_max_pods < 1:
        errs.append("scenario.repackMaxPods: must be at least 1")
    # unknown feature gates are rejected earlier, at FeatureGates
    # construction (featuregate.Set errors on unknown names)
    return errs


_CONFIG_FIELDS = {f.name for f in dataclasses.fields(KubeSchedulerConfiguration)}
_LE_FIELDS = {f.name for f in dataclasses.fields(LeaderElectionConfig)}
_ROB_FIELDS = {f.name for f in dataclasses.fields(RobustnessConfig)}
_REC_FIELDS = {f.name for f in dataclasses.fields(RecoveryConfig)}
_OBS_FIELDS = {f.name for f in dataclasses.fields(ObservabilityConfig)}
_LEDGER_FIELDS = {f.name for f in dataclasses.fields(LedgerConfig)}
_MEMLEDGER_FIELDS = {f.name for f in dataclasses.fields(MemoryLedgerConfig)}
_JOURNEYS_FIELDS = {f.name for f in dataclasses.fields(JourneysConfig)}
_INCIDENTS_FIELDS = {f.name for f in dataclasses.fields(IncidentsConfig)}
_WARMUP_FIELDS = {f.name for f in dataclasses.fields(WarmupConfig)}
_INC_FIELDS = {f.name for f in dataclasses.fields(IncrementalConfig)}
_SERVING_FIELDS = {f.name for f in dataclasses.fields(ServingConfig)}
_PAR_FIELDS = {f.name for f in dataclasses.fields(ParallelConfig)}
_SCN_FIELDS = {f.name for f in dataclasses.fields(ScenarioConfig)}


def decode_config(doc: dict, path: str = "") -> KubeSchedulerConfiguration:
    """Decode a mapping into the typed config, rejecting unknown fields
    (the reference's strict ComponentConfig decode fails on unknowns).

    An ``apiVersion``/``kind`` pair the scheme recognizes routes through
    the VERSIONED pipeline (build strict camelCase v1alpha1 -> default ->
    convert to internal — apis/config/scheme); untagged mappings use this
    implementation's native snake_case decode."""
    if not isinstance(doc, dict):
        raise ConfigError([f"{path or 'config'}: expected a mapping"])
    api_version = doc.get("apiVersion", "")
    if api_version:
        from kubernetes_tpu_torch.api.config_v1alpha1 import SCHEME
        from kubernetes_tpu_torch.api.scheme import SchemeError

        if SCHEME.recognizes(api_version, doc.get("kind", "")):
            try:
                return SCHEME.decode(doc, KubeSchedulerConfiguration)
            except SchemeError as e:
                raise ConfigError(e.errors)
        raise ConfigError([
            f"apiVersion: no kind {doc.get('kind', '')!r} registered for "
            f"{api_version!r}"
        ])
    errs: List[str] = []
    kw: dict = {}
    for key, val in doc.items():
        if key in ("apiVersion", "kind"):
            continue  # accepted for file-shape parity, not interpreted
        if key == "leader_election":
            if not isinstance(val, dict):
                errs.append("leaderElection: expected a mapping")
                continue
            unknown = set(val) - _LE_FIELDS
            if unknown:
                errs.append(
                    f"leaderElection: unknown field(s) {sorted(unknown)}"
                )
                continue
            kw["leader_election"] = LeaderElectionConfig(**val)
        elif key == "feature_gates":
            if not isinstance(val, dict):
                errs.append("featureGates: expected a mapping")
                continue
            try:
                kw["feature_gates"] = FeatureGates(overrides=dict(val))
            except ValueError as e:
                errs.append(f"featureGates: {e}")
        elif key == "robustness":
            if not isinstance(val, dict):
                errs.append("robustness: expected a mapping")
                continue
            unknown = set(val) - _ROB_FIELDS
            if unknown:
                errs.append(
                    f"robustness: unknown field(s) {sorted(unknown)}"
                )
                continue
            rkw = dict(val)
            if "fallback_chain" in rkw:
                rkw["fallback_chain"] = tuple(rkw["fallback_chain"])
            kw["robustness"] = RobustnessConfig(**rkw)
        elif key == "recovery":
            if not isinstance(val, dict):
                errs.append("recovery: expected a mapping")
                continue
            unknown = set(val) - _REC_FIELDS
            if unknown:
                errs.append(f"recovery: unknown field(s) {sorted(unknown)}")
                continue
            kw["recovery"] = RecoveryConfig(**val)
        elif key == "observability":
            if not isinstance(val, dict):
                errs.append("observability: expected a mapping")
                continue
            unknown = set(val) - _OBS_FIELDS
            if unknown:
                errs.append(
                    f"observability: unknown field(s) {sorted(unknown)}"
                )
                continue
            okw = dict(val)
            if "ledger" in okw:
                lval = okw["ledger"]
                if not isinstance(lval, dict):
                    errs.append("observability.ledger: expected a mapping")
                    continue
                lunknown = set(lval) - _LEDGER_FIELDS
                if lunknown:
                    errs.append(
                        f"observability.ledger: unknown field(s) "
                        f"{sorted(lunknown)}")
                    continue
                okw["ledger"] = LedgerConfig(**lval)
            if "memory_ledger" in okw:
                mval = okw["memory_ledger"]
                if not isinstance(mval, dict):
                    errs.append(
                        "observability.memoryLedger: expected a mapping")
                    continue
                munknown = set(mval) - _MEMLEDGER_FIELDS
                if munknown:
                    errs.append(
                        f"observability.memoryLedger: unknown field(s) "
                        f"{sorted(munknown)}")
                    continue
                okw["memory_ledger"] = MemoryLedgerConfig(**mval)
            if "journeys" in okw:
                jval = okw["journeys"]
                if not isinstance(jval, dict):
                    errs.append(
                        "observability.journeys: expected a mapping")
                    continue
                junknown = set(jval) - _JOURNEYS_FIELDS
                if junknown:
                    errs.append(
                        f"observability.journeys: unknown field(s) "
                        f"{sorted(junknown)}")
                    continue
                okw["journeys"] = JourneysConfig(**jval)
            if "incidents" in okw:
                ival = okw["incidents"]
                if not isinstance(ival, dict):
                    errs.append(
                        "observability.incidents: expected a mapping")
                    continue
                iunknown = set(ival) - _INCIDENTS_FIELDS
                if iunknown:
                    errs.append(
                        f"observability.incidents: unknown field(s) "
                        f"{sorted(iunknown)}")
                    continue
                okw["incidents"] = IncidentsConfig(**ival)
            kw["observability"] = ObservabilityConfig(**okw)
        elif key == "warmup":
            if not isinstance(val, dict):
                errs.append("warmup: expected a mapping")
                continue
            unknown = set(val) - _WARMUP_FIELDS
            if unknown:
                errs.append(f"warmup: unknown field(s) {sorted(unknown)}")
                continue
            wkw = dict(val)
            if "pod_buckets" in wkw:
                wkw["pod_buckets"] = tuple(wkw["pod_buckets"])
            kw["warmup"] = WarmupConfig(**wkw)
        elif key == "incremental":
            if not isinstance(val, dict):
                errs.append("incremental: expected a mapping")
                continue
            unknown = set(val) - _INC_FIELDS
            if unknown:
                errs.append(
                    f"incremental: unknown field(s) {sorted(unknown)}"
                )
                continue
            kw["incremental"] = IncrementalConfig(**val)
        elif key == "serving":
            if not isinstance(val, dict):
                errs.append("serving: expected a mapping")
                continue
            unknown = set(val) - _SERVING_FIELDS
            if unknown:
                errs.append(f"serving: unknown field(s) {sorted(unknown)}")
                continue
            kw["serving"] = ServingConfig(**val)
        elif key == "parallel":
            if not isinstance(val, dict):
                errs.append("parallel: expected a mapping")
                continue
            unknown = set(val) - _PAR_FIELDS
            if unknown:
                errs.append(f"parallel: unknown field(s) {sorted(unknown)}")
                continue
            kw["parallel"] = ParallelConfig(**val)
        elif key == "scenario":
            if not isinstance(val, dict):
                errs.append("scenario: expected a mapping")
                continue
            unknown = set(val) - _SCN_FIELDS
            if unknown:
                errs.append(f"scenario: unknown field(s) {sorted(unknown)}")
                continue
            kw["scenario"] = ScenarioConfig(**val)
        elif key == "policy":
            kw["policy"] = load_policy(val)
        elif key in _CONFIG_FIELDS:
            kw[key] = val
        else:
            errs.append(f"{key}: unknown field")
    if errs:
        raise ConfigError(errs)
    try:
        return KubeSchedulerConfiguration(**kw)
    except TypeError as e:
        raise ConfigError([str(e)])


def load_config_file(path: str) -> KubeSchedulerConfiguration:
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        import yaml

        try:
            doc = yaml.safe_load(text)
        except yaml.YAMLError as e:
            raise ConfigError([f"{path}: not valid JSON or YAML: {e}"])
    return decode_config(doc or {}, path)


def parse_feature_gates(spec: str) -> dict:
    """--feature-gates K=true,K2=false (component-base flag syntax)."""
    out = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ConfigError([f"feature-gates: missing '=' in {part!r}"])
        k, v = part.split("=", 1)
        if v.lower() not in ("true", "false"):
            raise ConfigError([f"feature-gates.{k}: must be true|false"])
        out[k.strip()] = v.lower() == "true"
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kubernetes_tpu_torch",
        description="batched scheduler on PyTorch and CUDA (kube-scheduler "
                    "capability analog)",
    )
    p.add_argument("--config", help="KubeSchedulerConfiguration file (YAML/JSON)")
    p.add_argument("--policy-config-file",
                   help="legacy Policy file (scheduler.go:178 policy source)")
    p.add_argument("--feature-gates", default="",
                   help="comma-separated K=true|false overrides")
    p.add_argument("--scheduler-name", default=None)
    p.add_argument("--solver", default=None, choices=VALID_SOLVERS)
    p.add_argument("--per-node-cap", type=int, default=None)
    p.add_argument("--pipeline-depth", type=int, default=None,
                   help="pipelined cycle executor depth (1 = monolithic)")
    p.add_argument("--pipeline-chunk", type=int, default=None,
                   help="sub-batch size of the pipelined executor")
    p.add_argument("--warmup", default=None, choices=("true", "false"),
                   help="AOT-compile the bucketed solve shapes at startup")
    p.add_argument("--incremental", default=None,
                   choices=("true", "false"),
                   help="incremental solve: device-resident score cache "
                        "+ restricted candidate-column solves + warm "
                        "Sinkhorn potentials (steady-state cycle cost "
                        "O(churn), cold solve stays the fallback)")
    p.add_argument("--sparse-primary", default=None,
                   choices=("true", "false"),
                   help="sparsity-first solve: restricted candidate "
                        "routing as the PRIMARY path (implies "
                        "--incremental true; full-snapshot cycles "
                        "rebuild the score plane and still solve "
                        "restricted, the cold path runs partitioned, "
                        "the candidate bucket auto-tunes; the dense "
                        "solve stays the correctness oracle)")
    p.add_argument("--mesh", default=None,
                   help="sharded execution backend: off | auto | N "
                        "(1-D device mesh over the node axis)")
    p.add_argument("--scenario", default=None,
                   help="scenario pack: consolidation | gang-topology "
                        "(pluggable solve objective + quality scores; "
                        "empty string turns the pack off)")
    p.add_argument("--percentage-of-nodes-to-score", type=int, default=None)
    p.add_argument("--leader-elect", default=None, choices=("true", "false"))
    p.add_argument("--lock-file", default=None,
                   help="leader-election lock file (FileLock path)")
    p.add_argument("--bind-address", default="127.0.0.1")
    p.add_argument("--port", type=int, default=10251,
                   help="healthz/metrics port (0 = ephemeral)")
    p.add_argument("--v", type=int, default=None,
                   help="log verbosity (klog --v analog; KTPU_V env)")
    p.add_argument("--validate-only", action="store_true",
                   help="decode + validate, print result, exit")
    p.add_argument("--version", action="store_true",
                   help="print version info and exit (pkg/version analog)")
    p.add_argument("--cycle-interval", type=float, default=0.25,
                   help="seconds between scheduling cycles when idle "
                        "(legacy mode; --serving replaces the timer "
                        "with wake-on-event)")
    p.add_argument("--serving", default=None, choices=("true", "false"),
                   help="event-driven micro-batch serving loop "
                        "(doorbell + accumulation window) instead of "
                        "the fixed-interval cycle timer")
    p.add_argument("--serving-max-wait", type=float, default=None,
                   help="micro-batch window latency ceiling, seconds")
    p.add_argument("--journeys", default=None, choices=("true", "false"),
                   help="per-pod journey tracer (phase-attributed "
                        "tail-latency timelines at /debug/journeys)")
    p.add_argument("--profile-dir", default=None,
                   help="artifact directory for triggered profiler "
                        "captures (empty = profiling off); arms "
                        "incident-triggered and /debug/profile captures")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the scheduler's tables and solve live: the "
                        "card (default; exits non-zero without one) or "
                        "the plain PyTorch path on the CPU")
    return p


def resolve_config(args) -> KubeSchedulerConfiguration:
    """File → flag overlay → validation (the options.Complete/Validate
    flow, app/server.go:133-148)."""
    cfg = (load_config_file(args.config) if args.config
           else KubeSchedulerConfiguration())
    if args.policy_config_file:
        with open(args.policy_config_file) as f:
            cfg = dataclasses.replace(cfg, policy=load_policy(json.load(f)))
    overlay = {}
    if args.scheduler_name is not None:
        overlay["scheduler_name"] = args.scheduler_name
    if args.solver is not None:
        overlay["solver"] = args.solver
    if args.per_node_cap is not None:
        overlay["per_node_cap"] = args.per_node_cap
    if args.pipeline_depth is not None:
        overlay["pipeline_depth"] = args.pipeline_depth
    if args.pipeline_chunk is not None:
        overlay["pipeline_chunk"] = args.pipeline_chunk
    if args.warmup is not None:
        overlay["warmup"] = dataclasses.replace(
            cfg.warmup, enabled=args.warmup == "true")
    if getattr(args, "incremental", None) is not None:
        overlay["incremental"] = dataclasses.replace(
            cfg.incremental, enabled=args.incremental == "true")
    if getattr(args, "sparse_primary", None) is not None:
        base = overlay.get("incremental", cfg.incremental)
        on = args.sparse_primary == "true"
        overlay["incremental"] = dataclasses.replace(
            base, enabled=base.enabled or on, primary=on,
            auto_tune=on)
    if getattr(args, "mesh", None) is not None:
        spec = args.mesh
        if spec not in ("off", "auto"):
            try:
                spec = int(spec)
            except ValueError:
                pass  # validate_config rejects with the field path
        overlay["parallel"] = dataclasses.replace(cfg.parallel, mesh=spec)
    if getattr(args, "scenario", None) is not None:
        overlay["scenario"] = dataclasses.replace(
            cfg.scenario, pack=args.scenario)
    serving_overlay = {}
    if getattr(args, "serving", None) is not None:
        serving_overlay["enabled"] = args.serving == "true"
    if getattr(args, "serving_max_wait", None) is not None:
        serving_overlay["max_wait_s"] = args.serving_max_wait
    if serving_overlay:
        overlay["serving"] = dataclasses.replace(
            cfg.serving, **serving_overlay)
    obs_overlay = {}
    if getattr(args, "journeys", None) is not None:
        obs_overlay["journeys"] = dataclasses.replace(
            cfg.observability.journeys, enabled=args.journeys == "true")
    if getattr(args, "profile_dir", None) is not None:
        obs_overlay["incidents"] = dataclasses.replace(
            cfg.observability.incidents, profile_dir=args.profile_dir)
    if obs_overlay:
        overlay["observability"] = dataclasses.replace(
            cfg.observability, **obs_overlay)
    if args.percentage_of_nodes_to_score is not None:
        overlay["percentage_of_nodes_to_score"] = args.percentage_of_nodes_to_score
    if args.leader_elect is not None:
        overlay["leader_election"] = dataclasses.replace(
            cfg.leader_election, leader_elect=args.leader_elect == "true"
        )
    if args.feature_gates:
        # flag gates overlay file gates in place (featuregate.Set on the
        # already-decoded object, options.go ApplyFeatureGates order)
        try:
            cfg.feature_gates.set_from_string(args.feature_gates)
        except ValueError as e:
            raise ConfigError([f"featureGates: {e}"])
    if overlay:
        cfg = dataclasses.replace(cfg, **overlay)
    errors = validate_config(cfg)
    if errors:
        raise ConfigError(errors)
    return cfg


def unported_features(cfg: KubeSchedulerConfiguration) -> List[str]:
    """What a valid configuration asks for that the port does not have
    yet, one message per setting, each naming its ROADMAP item. Every
    setting is ported now, so the list is empty; the seam stays for the
    next one. ``parallel.mesh`` resolves against the real devices where
    the scheduler is built: one card is a mesh of 1, several cards a mesh
    over them that runs the partitioned solve (``parallel.mesh``,
    ``parallel.collectives``); only a mesh that mixes device types is
    refused there (``parallel.mesh.make_mesh``)."""
    errs: List[str] = []
    return errs


def run(cfg: KubeSchedulerConfiguration, args, stop_event=None,
        on_ready=None) -> None:
    """The serve loop (app/server.go:161 Run): healthz/metrics server up
    first, then leader election gates the scheduling loop — a non-leader
    keeps serving healthz and ticking the elector (active-passive HA).
    Every exception of a cycle (a ``KernelError`` included) ends the loop
    and reaches the caller, after the lease is released and the server
    stopped. ``on_ready`` is the port's addition; the reference's run
    takes no such hook. It is called once on this thread, just before the
    loop starts, with what run built: ``{"sched", "runtime", "elector",
    "server"}`` (``runtime`` is None in the legacy loop). run builds the
    scheduler and the runtime itself, so a host that embeds it (the
    tests, the chip smoke test's serve arms) needs the hook to feed pod
    events through ``runtime.loop.ingest`` and to install its binder."""
    import os
    import threading

    from kubernetes_tpu_torch.leaderelection import (
        FileLock,
        InMemoryLock,
        LeaderElector,
    )
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.server import serve_scheduler
    from kubernetes_tpu_torch.serving import Doorbell, ServingRuntime

    sched = Scheduler.from_config(cfg, device=args.device)
    runtime = None
    fairness = None
    if cfg.serving.enabled:
        # the composed serving runtime (serving/compose.py): doorbell +
        # micro-batch loop + APF admission with the backend-pressure
        # saturation probe + watch hub. The APF filter lands on the
        # component's own HTTP surface: extender POSTs classify mutating
        # and shed with 429 + Retry-After, healthz/metrics/debug stay
        # exempt
        runtime = ServingRuntime(sched, cfg.serving, warmup=cfg.warmup)
        fairness = runtime.flow
    srv = serve_scheduler(sched, host=args.bind_address, port=args.port,
                          fairness=fairness)
    host, port = srv.server_address[:2]
    print(f"serving healthz/metrics on {host}:{port}", file=sys.stderr)

    stop = stop_event or threading.Event()

    def _sig(_s, _f):
        stop.set()

    try:
        signal.signal(signal.SIGTERM, _sig)
        signal.signal(signal.SIGINT, _sig)
    except ValueError:
        # signal handlers can only be installed on the main thread; an
        # embedded run (tests, a host process driving the loop on a
        # worker thread) relies on stop_event instead
        pass

    elector = None
    if cfg.leader_election.leader_elect:
        lock = (FileLock(args.lock_file) if args.lock_file
                else InMemoryLock())
        elector = LeaderElector(
            identity=f"{os.uname().nodename}_{os.getpid()}",
            lock=lock,
            config=cfg.leader_election,
        )
        # recovery wiring: the elector fences every bind, gaining the
        # lease runs takeover reconciliation, losing it drains in-flight
        # state; the composed runtime also relists its watchers across
        # every leadership change
        if runtime is not None:
            runtime.attach_elector(elector)
        else:
            sched.attach_elector(elector)
    #: the warmup is LAZY: it waits for the first node sync, or every
    #: warmed shape would carry an empty-cluster node bucket no real
    #: cycle matches. The serving runtime owns its own pending flag;
    #: this one is the legacy loop's
    warmup_pending = cfg.warmup.enabled
    # both modes carry the doorbell: the serving loop blocks on it, the
    # legacy loop uses it to tell "idle" from "work arrived while I was
    # solving" (the empty-queue skip below)
    bell = (runtime.bell if runtime is not None
            else sched.attach_doorbell(Doorbell()))

    def gate() -> bool:
        """The LEGACY loop's per-iteration admission: leader election (a
        non-leader keeps serving healthz and ticking the elector) and the
        lazy warmup. Single-threaded, so no ingest guard; the serving
        path uses runtime.gate."""
        nonlocal warmup_pending
        if elector is not None:
            if not elector.tick():
                stop.wait(cfg.leader_election.retry_period_s)
                return False
        if warmup_pending and sched.cache.node_count():
            sample = sched.queue.pending_pods().get("active", [])[:64]
            n = sched.warmup(sample_pods=sample)
            print(f"warmup: warmed {n} bucketed solve shapes",
                  file=sys.stderr)
            warmup_pending = False
        return True

    try:
        if on_ready is not None:
            on_ready({"sched": sched, "runtime": runtime,
                      "elector": elector, "server": srv})
        if runtime is not None:
            runtime.run(stop, elector=elector,
                        retry_period_s=cfg.leader_election.retry_period_s)
        else:
            while not stop.is_set():
                if not gate():
                    continue
                # idle fast path: an empty activeQ with no doorbell
                # activity since the last look means a solve could only
                # be empty — skip it and run queue maintenance instead
                if (sched.queue.pending_counts().get("active", 0) == 0
                        and not bell.consume()):
                    sched.idle_tick()
                    stop.wait(args.cycle_interval)
                    continue
                r = sched.schedule_cycle()
                if r.attempted == 0:
                    stop.wait(args.cycle_interval)
    finally:
        if (elector is not None and cfg.recovery.release_lease_on_shutdown
                and elector.is_leader()):
            # graceful failover: CAS an expired lease record so the
            # standby acquires on its next tick instead of waiting out
            # the full lease duration
            elector.release()
        srv.shutdown()
        srv.server_close()


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.version:
        from kubernetes_tpu_torch import version_info

        print(json.dumps(version_info()))
        return 0
    if args.v is not None:
        from kubernetes_tpu_torch.utils.klog import set_verbosity

        set_verbosity(args.v)
    try:
        cfg = resolve_config(args)
    except ConfigError as e:
        for err in e.errors:
            print(f"invalid configuration: {err}", file=sys.stderr)
        return 1
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    unported = unported_features(cfg)
    if unported:
        for err in unported:
            print(f"invalid configuration: {err}", file=sys.stderr)
        return 1
    if args.validate_only:
        print(f"configuration valid: scheduler={cfg.scheduler_name} "
              f"solver={cfg.solver}")
        return 0
    from kubernetes_tpu_torch import resolve_device

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    run(cfg, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
