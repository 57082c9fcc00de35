"""The scheduler ComponentConfig scheme: v1alpha1 <-> internal (the
port's copy of ``kubernetes_tpu/api/config_v1alpha1.py``).

The reference keeps the kube-scheduler's config types in two parallel
packages — the internal form the code consumes
(pkg/scheduler/apis/config/types.go:43) and the versioned wire form
(pkg/scheduler/apis/config/v1alpha1, staging .../kube-scheduler/config/
v1alpha1/types.go) — glued by a scheme that registers conversion and
defaulting (pkg/scheduler/apis/config/scheme/scheme.go:31 AddToScheme).
Here the internal form is :class:`kubernetes_tpu_torch.config.
KubeSchedulerConfiguration` (snake_case, float seconds) and this module
is the versioned side:

- :class:`KubeSchedulerConfigurationV1alpha1` — wire spelling
  (camelCase field names, metav1.Duration strings like ``"15s"``);
- ``set_defaults_*`` — v1alpha1 defaulting (v1alpha1/defaults.go:42):
  note percentageOfNodesToScore defaults to 0 (= the adaptive 50%->5%
  rule) in the VERSIONED type while this framework's internal default is
  100 (dense batch solver scores everything) — exactly the kind of skew
  the versioned/internal split exists to express;
- conversions both ways, registered on :data:`SCHEME`;
- :func:`parse_duration` / :func:`format_duration` — the metav1.Duration
  wire form (Go time.ParseDuration subset).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

from kubernetes_tpu_torch.api.scheme import Scheme, SchemeError
from kubernetes_tpu_torch.config import (
    FeatureGates,
    KubeSchedulerConfiguration,
    LeaderElectionConfig,
)

GROUP_VERSION = "kubescheduler.config.k8s.io/v1alpha1"
KIND = "KubeSchedulerConfiguration"

_DUR_RE = re.compile(r"(\d+(?:\.\d+)?)(ms|us|µs|ns|h|m|s)")
_UNIT_S = {"h": 3600.0, "m": 60.0, "s": 1.0, "ms": 1e-3, "us": 1e-6,
           "µs": 1e-6, "ns": 1e-9}


def parse_duration(s) -> float:
    """'1m30s' -> 90.0 (Go time.ParseDuration subset: positive decimal
    components with h/m/s/ms/us/ns units; bare numbers rejected the way
    metav1.Duration rejects them)."""
    if isinstance(s, (int, float)) and not isinstance(s, bool):
        # tolerate a raw number as seconds (YAML authors do this);
        # the reference's strict JSON would reject it, but a one-way
        # tolerance loses no information
        return float(s)
    if not isinstance(s, str) or not s:
        raise SchemeError([f"duration: invalid value {s!r}"])
    pos = 0
    total = 0.0
    for m in _DUR_RE.finditer(s):
        if m.start() != pos:
            raise SchemeError([f"duration: invalid value {s!r}"])
        total += float(m.group(1)) * _UNIT_S[m.group(2)]
        pos = m.end()
    if pos != len(s):
        raise SchemeError([f"duration: invalid value {s!r}"])
    return total


def format_duration(seconds: float) -> str:
    """Seconds -> the canonical wire string ('90s' stays '1m30s'-free:
    the reference emits the largest exact unit mix; whole seconds are by
    far the common case so h/m/s composition is enough)."""
    if seconds != seconds or seconds < 0:
        raise SchemeError([f"duration: invalid value {seconds!r}"])
    ns = round(seconds * 1e9)
    if ns == 0:
        return "0s"
    out = []
    for unit, unit_ns in (("h", 3_600_000_000_000), ("m", 60_000_000_000),
                          ("s", 1_000_000_000), ("ms", 1_000_000),
                          ("us", 1_000), ("ns", 1)):
        q, ns = divmod(ns, unit_ns)
        if q:
            out.append(f"{q}{unit}")
    return "".join(out)


# -- versioned types (wire spelling) ----------------------------------------


@dataclass
class SchedulerAlgorithmSource:
    """v1alpha1 SchedulerAlgorithmSource (types.go AlgorithmSource):
    provider XOR policy; here policy carries the inline Policy mapping."""

    provider: Optional[str] = None
    policy: Optional[dict] = None


@dataclass
class LeaderElectionConfigurationV1alpha1:
    leaderElect: Optional[bool] = None
    leaseDuration: Optional[str] = None
    renewDeadline: Optional[str] = None
    retryPeriod: Optional[str] = None
    lockObjectNamespace: Optional[str] = None
    lockObjectName: Optional[str] = None


@dataclass
class RobustnessConfigurationV1alpha1:
    """Versioned spelling of the degradation-ladder knobs
    (config.RobustnessConfig): camelCase, durations as metav1.Duration
    strings like every other versioned time field."""

    cycleDeadline: Optional[str] = None
    solverRetries: Optional[int] = None
    transportRetries: Optional[int] = None
    retryBackoffBase: Optional[str] = None
    retryBackoffMax: Optional[str] = None
    retryJitter: Optional[float] = None
    breakerFailureThreshold: Optional[int] = None
    breakerOpenDuration: Optional[str] = None
    breakerHalfOpenProbes: Optional[int] = None
    validateResults: Optional[bool] = None
    hostValidate: Optional[bool] = None
    fallbackChain: Optional[list] = None
    extenderDegradeToIgnorable: Optional[bool] = None
    bindVerifyRetries: Optional[int] = None
    watchProgressDeadline: Optional[str] = None  # "0s" = stall det. off


@dataclass
class RecoveryConfigurationV1alpha1:
    """Versioned spelling of the crash/failover/device-loss recovery
    knobs (config.RecoveryConfig): camelCase, the cooloff as a
    metav1.Duration string like every other versioned time field."""

    fencedBinds: Optional[bool] = None
    reconcileOnTakeover: Optional[bool] = None
    releaseLeaseOnShutdown: Optional[bool] = None
    deviceResetLimit: Optional[int] = None
    deviceCooloff: Optional[str] = None


@dataclass
class LedgerConfigurationV1alpha1:
    """Versioned spelling of the perf-ledger / SLO-watchdog block
    (config.LedgerConfig): camelCase, the objective and windows as
    metav1.Duration strings like every other versioned time field."""

    enabled: Optional[bool] = None
    history: Optional[int] = None
    distWindow: Optional[int] = None
    baselineDecay: Optional[float] = None
    e2eP99Objective: Optional[str] = None  # "0s" = objective off
    costDriftRatio: Optional[float] = None  # 0 = objective off
    fastWindow: Optional[str] = None
    slowWindow: Optional[str] = None
    burnThreshold: Optional[float] = None
    engagePressure: Optional[bool] = None


@dataclass
class MemoryLedgerConfigurationV1alpha1:
    """Versioned spelling of the device-memory ledger block
    (config.MemoryLedgerConfig): camelCase, the sample interval as a
    metav1.Duration string like every other versioned time field."""

    enabled: Optional[bool] = None
    sampleInterval: Optional[str] = None  # "0s" = every cycle boundary
    preflight: Optional[bool] = None
    headroomFrac: Optional[float] = None
    limitBytes: Optional[int] = None  # 0 = device-reported limit
    history: Optional[int] = None
    censusLimit: Optional[int] = None


@dataclass
class JourneysConfigurationV1alpha1:
    """Versioned spelling of the per-pod journey tracer block
    (config.JourneysConfig): camelCase, the retention window as a
    metav1.Duration string like every other versioned time field."""

    enabled: Optional[bool] = None
    slowK: Optional[int] = None
    sampleEvery: Optional[int] = None  # 0 = completion sampling off
    window: Optional[str] = None
    maxPending: Optional[int] = None
    maxEvents: Optional[int] = None


@dataclass
class IncidentsConfigurationV1alpha1:
    """Versioned spelling of the incident-autopsy block
    (config.IncidentsConfig): camelCase (no duration fields — the
    cooldown and flight window are cycle counts by design)."""

    enabled: Optional[bool] = None
    capacity: Optional[int] = None
    flightWindow: Optional[int] = None
    journeysK: Optional[int] = None
    cooldownCycles: Optional[int] = None
    fallbackBurstThreshold: Optional[int] = None  # 0 = trigger off
    profileCycles: Optional[int] = None  # 0 = incident-armed off
    profileDir: Optional[str] = None  # "" = profiling off entirely
    maxProfiles: Optional[int] = None


@dataclass
class LockSanitizerConfigurationV1alpha1:
    """Versioned spelling of the instrumented-lock sanitizer block
    (sanitize.LockSanitizerConfig): camelCase, the hold budget as a
    metav1.Duration string like every other versioned time field."""

    enabled: Optional[bool] = None
    holdBudget: Optional[str] = None  # "0s" = hold check off
    debugGuards: Optional[bool] = None
    maxFindings: Optional[int] = None


@dataclass
class ObservabilityConfigurationV1alpha1:
    """Versioned spelling of the observability knobs
    (config.ObservabilityConfig): camelCase, the trace threshold as a
    metav1.Duration string like every other versioned time field."""

    enabled: Optional[bool] = None
    traceThreshold: Optional[str] = None
    traceSampling: Optional[float] = None
    recorderCapacity: Optional[int] = None
    traceRingCapacity: Optional[int] = None
    retraceStormThreshold: Optional[int] = None
    retraceStormWindow: Optional[int] = None
    sinkhornTelemetry: Optional[bool] = None
    explain: Optional[bool] = None
    explainTopK: Optional[int] = None
    auditInterval: Optional[str] = None  # "0s" = serving auditor off
    ledger: "LedgerConfigurationV1alpha1" = field(
        default_factory=LedgerConfigurationV1alpha1)
    memoryLedger: "MemoryLedgerConfigurationV1alpha1" = field(
        default_factory=MemoryLedgerConfigurationV1alpha1)
    journeys: "JourneysConfigurationV1alpha1" = field(
        default_factory=JourneysConfigurationV1alpha1)
    incidents: "IncidentsConfigurationV1alpha1" = field(
        default_factory=IncidentsConfigurationV1alpha1)
    lockSanitizer: "LockSanitizerConfigurationV1alpha1" = field(
        default_factory=LockSanitizerConfigurationV1alpha1)


@dataclass
class WarmupConfigurationV1alpha1:
    """Versioned spelling of the AOT-warmup block (config.WarmupConfig):
    camelCase keys, explicit bucket list."""

    enabled: Optional[bool] = None
    podBuckets: Optional[list] = None
    minBucket: Optional[int] = None
    includeFilter: Optional[bool] = None
    hostFallback: Optional[bool] = None


@dataclass
class IncrementalConfigurationV1alpha1:
    """Versioned spelling of the incremental-solve block
    (config.IncrementalConfig): camelCase; fractions stay raw floats
    (no duration fields to re-spell)."""

    enabled: Optional[bool] = None
    candidateBucket: Optional[int] = None
    maxBatchFrac: Optional[float] = None
    maxDirtyFrac: Optional[float] = None
    warmPotentials: Optional[bool] = None
    warmTol: Optional[float] = None
    qualityDelta: Optional[float] = None
    primary: Optional[bool] = None
    coldBlocks: Optional[int] = None
    autoTune: Optional[bool] = None
    groupQuotaFrac: Optional[float] = None


@dataclass
class ParallelConfigurationV1alpha1:
    """Versioned spelling of the sharded-execution block
    (config.ParallelConfig): ``mesh`` is ``"off"`` | ``"auto"`` | an
    integer device count, same vocabulary as the internal type (no
    duration fields to re-spell)."""

    mesh: Optional[object] = None  # "off" | "auto" | int


@dataclass
class ScenarioConfigurationV1alpha1:
    """Versioned spelling of the scenario-pack block
    (config.ScenarioConfig): camelCase; the pack vocabulary is the
    internal one (no duration fields to re-spell)."""

    pack: Optional[str] = None
    costWeight: Optional[float] = None
    fillBlock: Optional[int] = None
    preemptInBatch: Optional[bool] = None
    cascadeMaxPods: Optional[int] = None
    superpod: Optional[int] = None
    quality: Optional[bool] = None
    repackInterval: Optional[str] = None  # duration; "0s" = off
    repackMaxPods: Optional[int] = None


@dataclass
class ServingConfigurationV1alpha1:
    """Versioned spelling of the streaming-serving block
    (config.ServingConfig): camelCase, windows as metav1.Duration
    strings like every other versioned time field."""

    enabled: Optional[bool] = None
    minWait: Optional[str] = None
    maxWait: Optional[str] = None
    targetBucket: Optional[int] = None
    idleWait: Optional[str] = None
    flowConcurrency: Optional[int] = None
    watchConcurrency: Optional[int] = None
    flowQueueLength: Optional[int] = None
    queueTimeout: Optional[str] = None
    retryAfter: Optional[str] = None
    watchBuffer: Optional[int] = None
    shedQueueBound: Optional[int] = None
    degradedPressureFactor: Optional[float] = None


@dataclass
class KubeSchedulerConfigurationV1alpha1:
    schedulerName: Optional[str] = None
    algorithmSource: "SchedulerAlgorithmSource" = field(
        default_factory=SchedulerAlgorithmSource)
    hardPodAffinitySymmetricWeight: Optional[int] = None
    percentageOfNodesToScore: Optional[int] = None
    bindTimeoutSeconds: Optional[float] = None
    leaderElection: "LeaderElectionConfigurationV1alpha1" = field(
        default_factory=LeaderElectionConfigurationV1alpha1)
    featureGates: Optional[dict] = None
    #: framework plugins: a flat enabled-name list (the per-extension-
    #: point Plugins struct is recast — see config.py) and the
    #: reference-shaped pluginConfig list of {name, args}
    #: (apis/config/types.go:127)
    plugins: Optional[list] = None
    pluginConfig: Optional[list] = None
    # this implementation's solver block, versioned alongside (camelCase
    # on the wire like every other field)
    solver: Optional[str] = None
    perNodeCap: Optional[int] = None
    maxRounds: Optional[int] = None
    maxBatch: Optional[int] = None
    # pipelined cycle executor + incremental device-resident snapshot
    pipelineDepth: Optional[int] = None
    pipelineChunk: Optional[int] = None
    deviceResidentSnapshot: Optional[bool] = None
    snapshotMaxDirtyFrac: Optional[float] = None
    incremental: "IncrementalConfigurationV1alpha1" = field(
        default_factory=IncrementalConfigurationV1alpha1)
    warmup: "WarmupConfigurationV1alpha1" = field(
        default_factory=WarmupConfigurationV1alpha1)
    robustness: "RobustnessConfigurationV1alpha1" = field(
        default_factory=RobustnessConfigurationV1alpha1)
    recovery: "RecoveryConfigurationV1alpha1" = field(
        default_factory=RecoveryConfigurationV1alpha1)
    observability: "ObservabilityConfigurationV1alpha1" = field(
        default_factory=ObservabilityConfigurationV1alpha1)
    serving: "ServingConfigurationV1alpha1" = field(
        default_factory=ServingConfigurationV1alpha1)
    parallel: "ParallelConfigurationV1alpha1" = field(
        default_factory=ParallelConfigurationV1alpha1)
    scenario: "ScenarioConfigurationV1alpha1" = field(
        default_factory=ScenarioConfigurationV1alpha1)


# -- defaulting (v1alpha1/defaults.go:42) -----------------------------------


def set_defaults_kube_scheduler_configuration(
        obj: KubeSchedulerConfigurationV1alpha1):
    if obj.schedulerName is None:
        obj.schedulerName = "default-scheduler"
    if obj.algorithmSource.provider is None and obj.algorithmSource.policy is None:
        obj.algorithmSource.provider = "DefaultProvider"
    if obj.hardPodAffinitySymmetricWeight is None:
        obj.hardPodAffinitySymmetricWeight = 1
    if obj.percentageOfNodesToScore is None:
        # 0 selects the reference's adaptive 50%->5% rule — the versioned
        # default; the internal type's own default is 100 (see module doc)
        obj.percentageOfNodesToScore = 0
    if obj.bindTimeoutSeconds is None:
        obj.bindTimeoutSeconds = 600.0
    le = obj.leaderElection
    if le.leaderElect is None:
        le.leaderElect = True
    if le.leaseDuration is None:
        le.leaseDuration = "15s"
    if le.renewDeadline is None:
        le.renewDeadline = "10s"
    if le.retryPeriod is None:
        le.retryPeriod = "2s"
    if le.lockObjectNamespace is None:
        le.lockObjectNamespace = "kube-system"
    if le.lockObjectName is None:
        le.lockObjectName = "kube-scheduler"
    if obj.solver is None:
        obj.solver = "batch"
    if obj.perNodeCap is None:
        obj.perNodeCap = 4
    if obj.maxRounds is None:
        obj.maxRounds = 128
    if obj.maxBatch is None:
        obj.maxBatch = 8192
    if obj.pipelineDepth is None:
        obj.pipelineDepth = 2
    if obj.pipelineChunk is None:
        obj.pipelineChunk = 4096
    if obj.deviceResidentSnapshot is None:
        obj.deviceResidentSnapshot = True
    if obj.snapshotMaxDirtyFrac is None:
        obj.snapshotMaxDirtyFrac = 0.25
    inc = obj.incremental
    if inc.enabled is None:
        inc.enabled = False
    if inc.candidateBucket is None:
        inc.candidateBucket = 256
    if inc.maxBatchFrac is None:
        inc.maxBatchFrac = 0.5
    if inc.maxDirtyFrac is None:
        inc.maxDirtyFrac = 0.25
    if inc.warmPotentials is None:
        inc.warmPotentials = True
    if inc.warmTol is None:
        inc.warmTol = 1e-3
    if inc.qualityDelta is None:
        inc.qualityDelta = 0.02
    if inc.primary is None:
        inc.primary = False
    if inc.coldBlocks is None:
        inc.coldBlocks = 0
    if inc.autoTune is None:
        inc.autoTune = False
    if inc.groupQuotaFrac is None:
        inc.groupQuotaFrac = 0.5
    wu = obj.warmup
    if wu.enabled is None:
        wu.enabled = False
    if wu.podBuckets is None:
        wu.podBuckets = []
    if wu.minBucket is None:
        wu.minBucket = 256
    if wu.includeFilter is None:
        wu.includeFilter = True
    if wu.hostFallback is None:
        wu.hostFallback = False
    rb = obj.robustness
    if rb.cycleDeadline is None:
        rb.cycleDeadline = "0s"  # 0 = unbounded (the internal default)
    if rb.solverRetries is None:
        rb.solverRetries = 1
    if rb.transportRetries is None:
        rb.transportRetries = 2
    if rb.retryBackoffBase is None:
        rb.retryBackoffBase = "50ms"
    if rb.retryBackoffMax is None:
        rb.retryBackoffMax = "2s"
    if rb.retryJitter is None:
        rb.retryJitter = 0.2
    if rb.breakerFailureThreshold is None:
        rb.breakerFailureThreshold = 3
    if rb.breakerOpenDuration is None:
        rb.breakerOpenDuration = "30s"
    if rb.breakerHalfOpenProbes is None:
        rb.breakerHalfOpenProbes = 1
    if rb.validateResults is None:
        rb.validateResults = True
    if rb.hostValidate is None:
        rb.hostValidate = False
    if rb.fallbackChain is None:
        rb.fallbackChain = ["batch-cpu", "greedy"]
    if rb.extenderDegradeToIgnorable is None:
        rb.extenderDegradeToIgnorable = True
    if rb.bindVerifyRetries is None:
        rb.bindVerifyRetries = 3
    if rb.watchProgressDeadline is None:
        rb.watchProgressDeadline = "30s"
    rv = obj.recovery
    if rv.fencedBinds is None:
        rv.fencedBinds = True
    if rv.reconcileOnTakeover is None:
        rv.reconcileOnTakeover = True
    if rv.releaseLeaseOnShutdown is None:
        rv.releaseLeaseOnShutdown = True
    if rv.deviceResetLimit is None:
        rv.deviceResetLimit = 2
    if rv.deviceCooloff is None:
        rv.deviceCooloff = "5s"
    ob = obj.observability
    if ob.enabled is None:
        ob.enabled = True
    if ob.traceThreshold is None:
        ob.traceThreshold = "1s"
    if ob.traceSampling is None:
        ob.traceSampling = 1.0
    if ob.recorderCapacity is None:
        ob.recorderCapacity = 256
    if ob.traceRingCapacity is None:
        ob.traceRingCapacity = 64
    if ob.retraceStormThreshold is None:
        ob.retraceStormThreshold = 8
    if ob.retraceStormWindow is None:
        ob.retraceStormWindow = 64
    if ob.sinkhornTelemetry is None:
        ob.sinkhornTelemetry = True
    if ob.explain is None:
        ob.explain = True
    if ob.explainTopK is None:
        ob.explainTopK = 3
    if ob.auditInterval is None:
        ob.auditInterval = "0s"  # serving-runtime auditor off (internal default)
    lg = ob.ledger
    if lg.enabled is None:
        lg.enabled = True
    if lg.history is None:
        lg.history = 256
    if lg.distWindow is None:
        lg.distWindow = 256
    if lg.baselineDecay is None:
        lg.baselineDecay = 0.05
    if lg.e2eP99Objective is None:
        lg.e2eP99Objective = "0s"  # objective off (the internal default)
    if lg.costDriftRatio is None:
        lg.costDriftRatio = 0.0
    if lg.fastWindow is None:
        lg.fastWindow = "1m0s"
    if lg.slowWindow is None:
        lg.slowWindow = "10m0s"
    if lg.burnThreshold is None:
        lg.burnThreshold = 1.0
    if lg.engagePressure is None:
        lg.engagePressure = True
    mlg = ob.memoryLedger
    if mlg.enabled is None:
        mlg.enabled = True
    # internal default: census off the per-cycle path ("0s" opts into
    # every-boundary sampling)
    if mlg.sampleInterval is None:
        mlg.sampleInterval = "500ms"
    if mlg.preflight is None:
        mlg.preflight = True
    if mlg.headroomFrac is None:
        mlg.headroomFrac = 0.9
    if mlg.limitBytes is None:
        mlg.limitBytes = 0  # device-reported limit
    if mlg.history is None:
        mlg.history = 128
    if mlg.censusLimit is None:
        mlg.censusLimit = 4096
    jy = ob.journeys
    if jy.enabled is None:
        jy.enabled = True
    if jy.slowK is None:
        jy.slowK = 8
    if jy.sampleEvery is None:
        jy.sampleEvery = 100
    if jy.window is None:
        jy.window = "5m0s"
    if jy.maxPending is None:
        jy.maxPending = 4096
    if jy.maxEvents is None:
        jy.maxEvents = 64
    ic = ob.incidents
    if ic.enabled is None:
        ic.enabled = True
    if ic.capacity is None:
        ic.capacity = 16
    if ic.flightWindow is None:
        ic.flightWindow = 16
    if ic.journeysK is None:
        ic.journeysK = 4
    if ic.cooldownCycles is None:
        ic.cooldownCycles = 64
    if ic.fallbackBurstThreshold is None:
        ic.fallbackBurstThreshold = 3
    if ic.profileCycles is None:
        ic.profileCycles = 0  # incident-armed profiling off
    if ic.profileDir is None:
        ic.profileDir = ""  # profiling off entirely
    if ic.maxProfiles is None:
        ic.maxProfiles = 4
    ls = ob.lockSanitizer
    if ls.enabled is None:
        ls.enabled = False  # plain threading locks by default
    if ls.holdBudget is None:
        ls.holdBudget = "250ms"
    if ls.debugGuards is None:
        ls.debugGuards = True
    if ls.maxFindings is None:
        ls.maxFindings = 256
    sv = obj.serving
    if sv.enabled is None:
        sv.enabled = False
    if sv.minWait is None:
        sv.minWait = "5ms"
    if sv.maxWait is None:
        sv.maxWait = "50ms"
    if sv.targetBucket is None:
        sv.targetBucket = 1024
    if sv.idleWait is None:
        sv.idleWait = "500ms"
    if sv.flowConcurrency is None:
        sv.flowConcurrency = 16
    if sv.watchConcurrency is None:
        sv.watchConcurrency = 8
    if sv.flowQueueLength is None:
        sv.flowQueueLength = 64
    if sv.queueTimeout is None:
        sv.queueTimeout = "1s"
    if sv.retryAfter is None:
        sv.retryAfter = "1s"
    if sv.watchBuffer is None:
        sv.watchBuffer = 4096
    if sv.shedQueueBound is None:
        sv.shedQueueBound = 0
    if sv.degradedPressureFactor is None:
        sv.degradedPressureFactor = 4.0
    pl = obj.parallel
    if pl.mesh is None:
        pl.mesh = "off"
    sn = obj.scenario
    if sn.pack is None:
        sn.pack = ""
    if sn.costWeight is None:
        sn.costWeight = 4.0
    if sn.fillBlock is None:
        sn.fillBlock = 64
    if sn.preemptInBatch is None:
        sn.preemptInBatch = True
    if sn.cascadeMaxPods is None:
        sn.cascadeMaxPods = 1024
    if sn.superpod is None:
        sn.superpod = 4
    if sn.quality is None:
        sn.quality = True
    if sn.repackInterval is None:
        sn.repackInterval = "0s"
    if sn.repackMaxPods is None:
        sn.repackMaxPods = 64
    return obj


# -- conversions (v1alpha1/zz_generated.conversion.go shape) ----------------


def _dur(field_name: str, value, prefix: str = "leaderElection") -> float:
    """parse_duration with the FIELD PATH stamped into the error — the
    module's error contract; a bare 'duration: invalid' gives the user
    no way to locate which of several duration fields failed."""
    try:
        return parse_duration(value)
    except SchemeError:
        raise SchemeError([
            f"{prefix}.{field_name}: invalid duration {value!r}"
        ])


def _to_internal(v: KubeSchedulerConfigurationV1alpha1) -> KubeSchedulerConfiguration:
    """Conversion proper. The default table lives in exactly one place
    (set_defaults_*): defaulting is idempotent, so it is re-applied here
    on a COPY unconditionally — Scheme.decode callers pay a no-op pass,
    direct convert() callers with raw/partial objects get correct
    defaults instead of a crash. Every error surfaces as SchemeError
    with a field path, never a raw ValueError/KeyError."""
    import copy

    from kubernetes_tpu_torch.config import load_policy

    v = set_defaults_kube_scheduler_configuration(copy.deepcopy(v))
    le = v.leaderElection
    policy = None
    if v.algorithmSource.policy is not None:
        try:
            policy = load_policy(v.algorithmSource.policy)
        except SchemeError:
            raise
        except Exception as e:
            raise SchemeError([f"algorithmSource.policy: {e}"])
    try:
        gates = FeatureGates(overrides=dict(v.featureGates or {}))
    except ValueError as e:
        raise SchemeError([f"featureGates: {e}"])
    plugins = v.plugins or []
    if not (isinstance(plugins, list)
            and all(isinstance(p, str) for p in plugins)):
        # a scalar string would tuple() into characters; the reference's
        # per-extension-point Plugins dict would tuple() into its keys —
        # both decode into garbage silently without this check
        raise SchemeError([
            "plugins: expected a list of plugin names "
            f"(got {type(plugins).__name__})"
        ])
    plugin_config = {}
    for i, entry in enumerate(v.pluginConfig or []):
        if not isinstance(entry, dict) or not entry.get("name"):
            raise SchemeError([f"pluginConfig[{i}].name: Required value"])
        unknown = set(entry) - {"name", "args"}
        if unknown:
            # strict-serializer posture, same as every other field
            raise SchemeError([
                f"pluginConfig[{i}].{k}: unknown field"
                for k in sorted(unknown)
            ])
        args = entry.get("args") or {}
        if not isinstance(args, dict):
            raise SchemeError([
                f"pluginConfig[{i}].args: expected a mapping "
                f"(got {type(args).__name__})"
            ])
        plugin_config[entry["name"]] = dict(args)
    try:
        bind_timeout = float(v.bindTimeoutSeconds)
    except (TypeError, ValueError):
        raise SchemeError([
            f"bindTimeoutSeconds: invalid value {v.bindTimeoutSeconds!r}"
        ])
    return KubeSchedulerConfiguration(
        scheduler_name=v.schedulerName,
        algorithm_provider=v.algorithmSource.provider or "DefaultProvider",
        policy=policy,
        hard_pod_affinity_symmetric_weight=v.hardPodAffinitySymmetricWeight,
        percentage_of_nodes_to_score=v.percentageOfNodesToScore,
        bind_timeout_seconds=bind_timeout,
        leader_election=LeaderElectionConfig(
            leader_elect=le.leaderElect,
            lease_duration_s=_dur("leaseDuration", le.leaseDuration),
            renew_deadline_s=_dur("renewDeadline", le.renewDeadline),
            retry_period_s=_dur("retryPeriod", le.retryPeriod),
            lock_object_namespace=le.lockObjectNamespace,
            lock_object_name=le.lockObjectName,
        ),
        feature_gates=gates,
        plugins=tuple(plugins),
        plugin_config=plugin_config,
        solver=v.solver,
        per_node_cap=v.perNodeCap,
        max_rounds=v.maxRounds,
        max_batch=v.maxBatch,
        pipeline_depth=v.pipelineDepth,
        pipeline_chunk=v.pipelineChunk,
        device_resident_snapshot=v.deviceResidentSnapshot,
        snapshot_max_dirty_frac=v.snapshotMaxDirtyFrac,
        incremental=_incremental_to_internal(v.incremental),
        warmup=_warmup_to_internal(v.warmup),
        robustness=_robustness_to_internal(v.robustness),
        recovery=_recovery_to_internal(v.recovery),
        observability=_observability_to_internal(v.observability),
        serving=_serving_to_internal(v.serving),
        parallel=_parallel_to_internal(v.parallel),
        scenario=_scenario_to_internal(v.scenario),
    )


def _scenario_to_internal(sn: ScenarioConfigurationV1alpha1):
    from kubernetes_tpu_torch.config import ScenarioConfig

    if not isinstance(sn.pack, str):
        raise SchemeError([
            f"scenario.pack: invalid value {sn.pack!r}: expected a pack "
            "name string ('' = off)"
        ])
    return ScenarioConfig(
        pack=sn.pack,
        cost_weight=sn.costWeight,
        fill_block=sn.fillBlock,
        preempt_in_batch=sn.preemptInBatch,
        cascade_max_pods=sn.cascadeMaxPods,
        superpod=sn.superpod,
        quality=sn.quality,
        repack_interval_s=_dur("repackInterval", sn.repackInterval,
                               "scenario"),
        repack_max_pods=sn.repackMaxPods,
    )


def _incremental_to_internal(inc: IncrementalConfigurationV1alpha1):
    from kubernetes_tpu_torch.config import IncrementalConfig

    return IncrementalConfig(
        enabled=inc.enabled,
        candidate_bucket=inc.candidateBucket,
        max_batch_frac=inc.maxBatchFrac,
        max_dirty_frac=inc.maxDirtyFrac,
        warm_potentials=inc.warmPotentials,
        warm_tol=inc.warmTol,
        quality_delta=inc.qualityDelta,
        primary=inc.primary,
        cold_blocks=inc.coldBlocks,
        auto_tune=inc.autoTune,
        group_quota_frac=inc.groupQuotaFrac,
    )


def _parallel_to_internal(pl: ParallelConfigurationV1alpha1):
    from kubernetes_tpu_torch.config import ParallelConfig

    mesh = pl.mesh
    ok = mesh in ("off", "auto") or (
        isinstance(mesh, int) and not isinstance(mesh, bool) and mesh >= 1)
    if not ok:
        raise SchemeError([
            f"parallel.mesh: invalid value {mesh!r}: expected 'off', "
            "'auto', or a positive device count"
        ])
    return ParallelConfig(mesh=mesh)


def _recovery_to_internal(rv: RecoveryConfigurationV1alpha1):
    from kubernetes_tpu_torch.config import RecoveryConfig

    return RecoveryConfig(
        fenced_binds=rv.fencedBinds,
        reconcile_on_takeover=rv.reconcileOnTakeover,
        release_lease_on_shutdown=rv.releaseLeaseOnShutdown,
        device_reset_limit=rv.deviceResetLimit,
        device_cooloff_s=_dur("deviceCooloff", rv.deviceCooloff,
                              "recovery"),
    )


def _serving_to_internal(sv: ServingConfigurationV1alpha1):
    from kubernetes_tpu_torch.config import ServingConfig

    return ServingConfig(
        enabled=sv.enabled,
        min_wait_s=_dur("minWait", sv.minWait, "serving"),
        max_wait_s=_dur("maxWait", sv.maxWait, "serving"),
        target_bucket=sv.targetBucket,
        idle_wait_s=_dur("idleWait", sv.idleWait, "serving"),
        flow_concurrency=sv.flowConcurrency,
        watch_concurrency=sv.watchConcurrency,
        flow_queue_length=sv.flowQueueLength,
        queue_timeout_s=_dur("queueTimeout", sv.queueTimeout, "serving"),
        retry_after_s=_dur("retryAfter", sv.retryAfter, "serving"),
        watch_buffer=sv.watchBuffer,
        shed_queue_bound=sv.shedQueueBound,
        degraded_pressure_factor=sv.degradedPressureFactor,
    )


def _warmup_to_internal(wu: WarmupConfigurationV1alpha1):
    from kubernetes_tpu_torch.config import WarmupConfig

    buckets = wu.podBuckets
    if not (isinstance(buckets, list)
            and all(isinstance(b, int) and not isinstance(b, bool)
                    for b in buckets)):
        raise SchemeError([
            "warmup.podBuckets: expected a list of integers "
            f"(got {type(buckets).__name__})"
        ])
    return WarmupConfig(
        enabled=wu.enabled,
        pod_buckets=tuple(buckets),
        min_bucket=wu.minBucket,
        include_filter=wu.includeFilter,
        host_fallback=wu.hostFallback,
    )


def _observability_to_internal(ob: ObservabilityConfigurationV1alpha1):
    from kubernetes_tpu_torch.config import (
        IncidentsConfig,
        JourneysConfig,
        LedgerConfig,
        MemoryLedgerConfig,
        ObservabilityConfig,
    )
    from kubernetes_tpu_torch.sanitize import LockSanitizerConfig

    lg = ob.ledger
    mlg = ob.memoryLedger
    jy = ob.journeys
    ic = ob.incidents
    ls = ob.lockSanitizer
    return ObservabilityConfig(
        enabled=ob.enabled,
        trace_threshold_s=_dur("traceThreshold", ob.traceThreshold,
                               "observability"),
        trace_sampling=ob.traceSampling,
        recorder_capacity=ob.recorderCapacity,
        trace_ring_capacity=ob.traceRingCapacity,
        retrace_storm_threshold=ob.retraceStormThreshold,
        retrace_storm_window=ob.retraceStormWindow,
        sinkhorn_telemetry=ob.sinkhornTelemetry,
        explain=ob.explain,
        explain_top_k=ob.explainTopK,
        audit_interval_s=_dur("auditInterval", ob.auditInterval,
                              "observability"),
        ledger=LedgerConfig(
            enabled=lg.enabled,
            history=lg.history,
            dist_window=lg.distWindow,
            baseline_decay=lg.baselineDecay,
            e2e_p99_objective_s=_dur("ledger.e2eP99Objective",
                                     lg.e2eP99Objective, "observability"),
            cost_drift_ratio=lg.costDriftRatio,
            fast_window_s=_dur("ledger.fastWindow", lg.fastWindow,
                               "observability"),
            slow_window_s=_dur("ledger.slowWindow", lg.slowWindow,
                               "observability"),
            burn_threshold=lg.burnThreshold,
            engage_pressure=lg.engagePressure,
        ),
        memory_ledger=MemoryLedgerConfig(
            enabled=mlg.enabled,
            sample_interval_s=_dur("memoryLedger.sampleInterval",
                                   mlg.sampleInterval, "observability"),
            preflight=mlg.preflight,
            headroom_frac=mlg.headroomFrac,
            limit_bytes=mlg.limitBytes,
            history=mlg.history,
            census_limit=mlg.censusLimit,
        ),
        journeys=JourneysConfig(
            enabled=jy.enabled,
            slow_k=jy.slowK,
            sample_every=jy.sampleEvery,
            window_s=_dur("journeys.window", jy.window, "observability"),
            max_pending=jy.maxPending,
            max_events=jy.maxEvents,
        ),
        incidents=IncidentsConfig(
            enabled=ic.enabled,
            capacity=ic.capacity,
            flight_window=ic.flightWindow,
            journeys_k=ic.journeysK,
            cooldown_cycles=ic.cooldownCycles,
            fallback_burst_threshold=ic.fallbackBurstThreshold,
            profile_cycles=ic.profileCycles,
            profile_dir=ic.profileDir,
            max_profiles=ic.maxProfiles,
        ),
        lock_sanitizer=LockSanitizerConfig(
            enabled=ls.enabled,
            hold_budget_s=_dur("lockSanitizer.holdBudget", ls.holdBudget,
                               "observability"),
            debug_guards=ls.debugGuards,
            max_findings=ls.maxFindings,
        ),
    )


def _robustness_to_internal(rb: RobustnessConfigurationV1alpha1):
    from kubernetes_tpu_torch.config import RobustnessConfig

    chain = rb.fallbackChain
    if not (isinstance(chain, list)
            and all(isinstance(t, str) for t in chain)):
        raise SchemeError([
            "robustness.fallbackChain: expected a list of tier names "
            f"(got {type(chain).__name__})"
        ])
    return RobustnessConfig(
        cycle_deadline_s=_dur("cycleDeadline", rb.cycleDeadline,
                              "robustness"),
        solver_retries=rb.solverRetries,
        transport_retries=rb.transportRetries,
        retry_backoff_base_s=_dur("retryBackoffBase", rb.retryBackoffBase,
                                  "robustness"),
        retry_backoff_max_s=_dur("retryBackoffMax", rb.retryBackoffMax,
                                 "robustness"),
        retry_jitter=rb.retryJitter,
        breaker_failure_threshold=rb.breakerFailureThreshold,
        breaker_open_duration_s=_dur("breakerOpenDuration",
                                     rb.breakerOpenDuration, "robustness"),
        breaker_half_open_probes=rb.breakerHalfOpenProbes,
        validate_results=rb.validateResults,
        host_validate=rb.hostValidate,
        fallback_chain=tuple(chain),
        extender_degrade_to_ignorable=rb.extenderDegradeToIgnorable,
        bind_verify_retries=rb.bindVerifyRetries,
        watch_progress_deadline_s=_dur("watchProgressDeadline",
                                       rb.watchProgressDeadline,
                                       "robustness"),
    )


def _from_internal(c: KubeSchedulerConfiguration) -> KubeSchedulerConfigurationV1alpha1:
    le = c.leader_election
    rc = c.robustness
    gates = c.feature_gates.overrides() or None
    return KubeSchedulerConfigurationV1alpha1(
        schedulerName=c.scheduler_name,
        algorithmSource=SchedulerAlgorithmSource(
            provider=c.algorithm_provider if c.policy is None else None,
            policy=None,  # Policy objects don't encode back (one-way,
            # like the reference's file-referenced policy source)
        ),
        hardPodAffinitySymmetricWeight=c.hard_pod_affinity_symmetric_weight,
        percentageOfNodesToScore=c.percentage_of_nodes_to_score,
        bindTimeoutSeconds=c.bind_timeout_seconds,
        leaderElection=LeaderElectionConfigurationV1alpha1(
            leaderElect=le.leader_elect,
            leaseDuration=format_duration(le.lease_duration_s),
            renewDeadline=format_duration(le.renew_deadline_s),
            retryPeriod=format_duration(le.retry_period_s),
            lockObjectNamespace=le.lock_object_namespace,
            lockObjectName=le.lock_object_name,
        ),
        featureGates=gates,
        plugins=list(c.plugins) or None,
        pluginConfig=[{"name": k, "args": dict(v)}
                      for k, v in c.plugin_config.items()] or None,
        solver=c.solver,
        perNodeCap=c.per_node_cap,
        maxRounds=c.max_rounds,
        maxBatch=c.max_batch,
        pipelineDepth=c.pipeline_depth,
        pipelineChunk=c.pipeline_chunk,
        deviceResidentSnapshot=c.device_resident_snapshot,
        snapshotMaxDirtyFrac=c.snapshot_max_dirty_frac,
        incremental=IncrementalConfigurationV1alpha1(
            enabled=c.incremental.enabled,
            candidateBucket=c.incremental.candidate_bucket,
            maxBatchFrac=c.incremental.max_batch_frac,
            maxDirtyFrac=c.incremental.max_dirty_frac,
            warmPotentials=c.incremental.warm_potentials,
            warmTol=c.incremental.warm_tol,
            qualityDelta=c.incremental.quality_delta,
            primary=c.incremental.primary,
            coldBlocks=c.incremental.cold_blocks,
            autoTune=c.incremental.auto_tune,
            groupQuotaFrac=c.incremental.group_quota_frac,
        ),
        warmup=WarmupConfigurationV1alpha1(
            enabled=c.warmup.enabled,
            podBuckets=list(c.warmup.pod_buckets),
            minBucket=c.warmup.min_bucket,
            includeFilter=c.warmup.include_filter,
            hostFallback=c.warmup.host_fallback,
        ),
        robustness=RobustnessConfigurationV1alpha1(
            cycleDeadline=format_duration(rc.cycle_deadline_s),
            solverRetries=rc.solver_retries,
            transportRetries=rc.transport_retries,
            retryBackoffBase=format_duration(rc.retry_backoff_base_s),
            retryBackoffMax=format_duration(rc.retry_backoff_max_s),
            retryJitter=rc.retry_jitter,
            breakerFailureThreshold=rc.breaker_failure_threshold,
            breakerOpenDuration=format_duration(rc.breaker_open_duration_s),
            breakerHalfOpenProbes=rc.breaker_half_open_probes,
            validateResults=rc.validate_results,
            hostValidate=rc.host_validate,
            fallbackChain=list(rc.fallback_chain),
            extenderDegradeToIgnorable=rc.extender_degrade_to_ignorable,
            bindVerifyRetries=rc.bind_verify_retries,
            watchProgressDeadline=format_duration(
                rc.watch_progress_deadline_s),
        ),
        recovery=RecoveryConfigurationV1alpha1(
            fencedBinds=c.recovery.fenced_binds,
            reconcileOnTakeover=c.recovery.reconcile_on_takeover,
            releaseLeaseOnShutdown=c.recovery.release_lease_on_shutdown,
            deviceResetLimit=c.recovery.device_reset_limit,
            deviceCooloff=format_duration(c.recovery.device_cooloff_s),
        ),
        observability=ObservabilityConfigurationV1alpha1(
            enabled=c.observability.enabled,
            traceThreshold=format_duration(c.observability.trace_threshold_s),
            traceSampling=c.observability.trace_sampling,
            recorderCapacity=c.observability.recorder_capacity,
            traceRingCapacity=c.observability.trace_ring_capacity,
            retraceStormThreshold=c.observability.retrace_storm_threshold,
            retraceStormWindow=c.observability.retrace_storm_window,
            sinkhornTelemetry=c.observability.sinkhorn_telemetry,
            explain=c.observability.explain,
            explainTopK=c.observability.explain_top_k,
            auditInterval=format_duration(
                c.observability.audit_interval_s),
            ledger=LedgerConfigurationV1alpha1(
                enabled=c.observability.ledger.enabled,
                history=c.observability.ledger.history,
                distWindow=c.observability.ledger.dist_window,
                baselineDecay=c.observability.ledger.baseline_decay,
                e2eP99Objective=format_duration(
                    c.observability.ledger.e2e_p99_objective_s),
                costDriftRatio=c.observability.ledger.cost_drift_ratio,
                fastWindow=format_duration(
                    c.observability.ledger.fast_window_s),
                slowWindow=format_duration(
                    c.observability.ledger.slow_window_s),
                burnThreshold=c.observability.ledger.burn_threshold,
                engagePressure=c.observability.ledger.engage_pressure,
            ),
            memoryLedger=MemoryLedgerConfigurationV1alpha1(
                enabled=c.observability.memory_ledger.enabled,
                sampleInterval=format_duration(
                    c.observability.memory_ledger.sample_interval_s),
                preflight=c.observability.memory_ledger.preflight,
                headroomFrac=c.observability.memory_ledger.headroom_frac,
                limitBytes=c.observability.memory_ledger.limit_bytes,
                history=c.observability.memory_ledger.history,
                censusLimit=c.observability.memory_ledger.census_limit,
            ),
            journeys=JourneysConfigurationV1alpha1(
                enabled=c.observability.journeys.enabled,
                slowK=c.observability.journeys.slow_k,
                sampleEvery=c.observability.journeys.sample_every,
                window=format_duration(
                    c.observability.journeys.window_s),
                maxPending=c.observability.journeys.max_pending,
                maxEvents=c.observability.journeys.max_events,
            ),
            incidents=IncidentsConfigurationV1alpha1(
                enabled=c.observability.incidents.enabled,
                capacity=c.observability.incidents.capacity,
                flightWindow=c.observability.incidents.flight_window,
                journeysK=c.observability.incidents.journeys_k,
                cooldownCycles=c.observability.incidents.cooldown_cycles,
                fallbackBurstThreshold=(
                    c.observability.incidents.fallback_burst_threshold),
                profileCycles=c.observability.incidents.profile_cycles,
                profileDir=c.observability.incidents.profile_dir,
                maxProfiles=c.observability.incidents.max_profiles,
            ),
            lockSanitizer=LockSanitizerConfigurationV1alpha1(
                enabled=c.observability.lock_sanitizer.enabled,
                holdBudget=format_duration(
                    c.observability.lock_sanitizer.hold_budget_s),
                debugGuards=c.observability.lock_sanitizer.debug_guards,
                maxFindings=c.observability.lock_sanitizer.max_findings,
            ),
        ),
        serving=ServingConfigurationV1alpha1(
            enabled=c.serving.enabled,
            minWait=format_duration(c.serving.min_wait_s),
            maxWait=format_duration(c.serving.max_wait_s),
            targetBucket=c.serving.target_bucket,
            idleWait=format_duration(c.serving.idle_wait_s),
            flowConcurrency=c.serving.flow_concurrency,
            watchConcurrency=c.serving.watch_concurrency,
            flowQueueLength=c.serving.flow_queue_length,
            queueTimeout=format_duration(c.serving.queue_timeout_s),
            retryAfter=format_duration(c.serving.retry_after_s),
            watchBuffer=c.serving.watch_buffer,
            shedQueueBound=c.serving.shed_queue_bound,
            degradedPressureFactor=c.serving.degraded_pressure_factor,
        ),
        parallel=ParallelConfigurationV1alpha1(mesh=c.parallel.mesh),
        scenario=ScenarioConfigurationV1alpha1(
            pack=c.scenario.pack,
            costWeight=c.scenario.cost_weight,
            fillBlock=c.scenario.fill_block,
            preemptInBatch=c.scenario.preempt_in_batch,
            cascadeMaxPods=c.scenario.cascade_max_pods,
            superpod=c.scenario.superpod,
            quality=c.scenario.quality,
            repackInterval=format_duration(c.scenario.repack_interval_s),
            repackMaxPods=c.scenario.repack_max_pods,
        ),
    )


def new_scheme() -> Scheme:
    """AddToScheme (scheme/scheme.go:39): register kinds, defaulting,
    and both conversion directions on a fresh Scheme."""
    s = Scheme()
    s.register(GROUP_VERSION, KIND, KubeSchedulerConfigurationV1alpha1)
    s.add_defaulting(KubeSchedulerConfigurationV1alpha1,
                     set_defaults_kube_scheduler_configuration)
    s.add_conversion(KubeSchedulerConfigurationV1alpha1,
                     KubeSchedulerConfiguration, _to_internal)
    s.add_conversion(KubeSchedulerConfiguration,
                     KubeSchedulerConfigurationV1alpha1, _from_internal)
    return s


SCHEME = new_scheme()


def decode(doc: dict) -> KubeSchedulerConfiguration:
    """Versioned mapping -> internal config (the codec path the CLI
    uses for apiVersion-tagged files)."""
    return SCHEME.decode(doc, KubeSchedulerConfiguration)


def encode(cfg: KubeSchedulerConfiguration) -> dict:
    return SCHEME.encode(cfg, GROUP_VERSION, KIND)
