"""Scheduling Framework — the v1alpha1 plugin extension points
(``pkg/scheduler/framework/v1alpha1/interface.go``) adapted to the batched
TPU driver.

Extension points and semantics mirror the reference: QueueSort, PreFilter,
Filter, Score, Reserve, Permit, PreBind, Bind, PostBind, Unreserve; Status
codes Success/Error/Unschedulable/Wait/Skip (interface.go:40-53); a
per-cycle CycleState KV store (context.go PluginContext); and a
waiting-pods map for Permit (waiting_pods_map.go).

TPU-first adaptation: the in-tree predicates/priorities are NOT framework
plugins here — they are the fused device kernels (`ops.predicates` /
`ops.priorities`), which is the whole point of the port. The framework
layer is the *extension seam* for everything else, with two plugin flavors:

- **batch plugins** (``filter_batch`` / ``score_batch``): produce a whole
  (P, N) mask/score matrix from the device tables — the idiomatic way to
  add a custom vectorized predicate or priority without leaving the
  device path.
- **host plugins** (``filter`` / ``score``): per-(pod, nodeName) Python
  callbacks matching the reference's signatures — the escape hatch for
  logic that cannot be tensorized (it evaluates once per cycle against
  the packed snapshot and joins the solve as an extra mask/score, which
  keeps the reference's "filter runs before score" contract).

Reserve/Permit/PreBind/Bind/PostBind/Unreserve are host-side by nature
(they guard the assume/bind transaction) and match the reference's
call order in scheduleOne (scheduler.go:462,:531-:598).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from kubernetes_tpu_torch.api.types import Pod

# ---------------------------------------------------------------------------
# Status (interface.go:40-99)
# ---------------------------------------------------------------------------

SUCCESS = 0
ERROR = 1
UNSCHEDULABLE = 2
WAIT = 3
SKIP = 4

_CODE_NAMES = {SUCCESS: "Success", ERROR: "Error", UNSCHEDULABLE: "Unschedulable",
               WAIT: "Wait", SKIP: "Skip"}


@dataclass
class Status:
    code: int = SUCCESS
    message: str = ""

    def is_success(self) -> bool:
        return self.code == SUCCESS

    def code_name(self) -> str:
        return _CODE_NAMES.get(self.code, str(self.code))


#: the nil-Status convention: None is Success (interface.go:58)
def status_of(s: Optional[Status]) -> Status:
    return s if s is not None else Status()


# ---------------------------------------------------------------------------
# CycleState (context.go PluginContext)
# ---------------------------------------------------------------------------


class CycleState:
    """Per-scheduling-cycle key/value store shared across plugins. The
    reference guards it with a RWMutex for its parallel fan-outs; the host
    driver is single-threaded so plain dict semantics suffice."""

    def __init__(self) -> None:
        self._data: Dict[str, Any] = {}

    def read(self, key: str) -> Any:
        if key not in self._data:
            raise KeyError(key)
        return self._data[key]

    def write(self, key: str, value: Any) -> None:
        self._data[key] = value

    def delete(self, key: str) -> None:
        self._data.pop(key, None)


# ---------------------------------------------------------------------------
# Plugin interfaces. Python duck-typing replaces the Go interface checks:
# a plugin implements an extension point by defining its method.
# ---------------------------------------------------------------------------


class Plugin:
    """Base plugin; subclass and implement any extension-point methods:

    - ``less(pod_info_a, pod_info_b) -> bool``           (QueueSort)
    - ``pre_filter(state, pod) -> Status``               (PreFilter)
    - ``filter(state, pod, node_name) -> Status``        (Filter, host)
    - ``filter_batch(state, dp, dn, ds) -> (P,N) bool``  (Filter, device)
    - ``score(state, pod, node_name) -> (int, Status)``  (Score, host)
    - ``score_batch(state, dp, dn, ds) -> (P,N) f32``    (Score, device)
    - ``score_weight() -> float``                        (Score weight, default 1)
    - ``reserve(state, pod, node_name) -> Status``       (Reserve)
    - ``permit(state, pod, node_name) -> (Status, timeout_s)``  (Permit)
    - ``pre_bind(state, pod, node_name) -> Status``      (PreBind)
    - ``bind(state, pod, node_name) -> Status``          (Bind; SKIP = not handled)
    - ``post_bind(state, pod, node_name)``               (PostBind)
    - ``unreserve(state, pod, node_name)``               (Unreserve)
    """

    def name(self) -> str:
        return type(self).__name__


#: plugin factory registry (framework/v1alpha1/registry.go): name ->
#: factory(args) -> Plugin. Out-of-tree injection point (app/server.go:341
#: WithPlugin analog).
PLUGIN_REGISTRY: Dict[str, Callable[[dict], Plugin]] = {}


def register_plugin(name: str, factory: Callable[[dict], Plugin]) -> None:
    PLUGIN_REGISTRY[name] = factory


# ---------------------------------------------------------------------------
# Waiting pods (Permit -> Wait; waiting_pods_map.go)
# ---------------------------------------------------------------------------


@dataclass
class WaitingPod:
    pod: Pod
    node_name: str
    deadline: float
    allowed: bool = False
    rejected: Optional[str] = None  # rejection message

    def allow(self) -> None:
        self.allowed = True

    def reject(self, msg: str) -> None:
        self.rejected = msg or "rejected"


class WaitingPodsMap:
    def __init__(self) -> None:
        self._pods: Dict[str, WaitingPod] = {}

    def add(self, wp: WaitingPod) -> None:
        self._pods[wp.pod.key()] = wp

    def get(self, key: str) -> Optional[WaitingPod]:
        return self._pods.get(key)

    def remove(self, key: str) -> None:
        self._pods.pop(key, None)

    def items(self) -> List[WaitingPod]:
        return list(self._pods.values())

    def __len__(self) -> int:
        return len(self._pods)


# ---------------------------------------------------------------------------
# Framework (framework.go)
# ---------------------------------------------------------------------------


class Framework:
    """Runs configured plugins at each extension point, in registration
    order, short-circuiting on the first non-success status exactly like
    the reference's Run*Plugins methods (framework.go)."""

    def __init__(
        self,
        plugins: Sequence[Plugin] = (),
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.plugins = list(plugins)
        self.clock = clock
        self.waiting = WaitingPodsMap()

    def _with(self, method: str) -> List[Plugin]:
        return [p for p in self.plugins if hasattr(p, method)]

    # -- queue sort --------------------------------------------------------

    def queue_sort_less(self) -> Optional[Callable]:
        """Only one QueueSort plugin may be enabled (interface.go:131);
        None = use the default priority/timestamp comparator."""
        sorters = self._with("less")
        if len(sorters) > 1:
            raise ValueError("only one QueueSort plugin may be enabled")
        return sorters[0].less if sorters else None

    # -- batched mask/score contributions ----------------------------------

    def has_host_filters(self) -> bool:
        return bool(self._with("filter"))

    def has_host_scores(self) -> bool:
        return bool(self._with("score"))

    def has_batch_filters(self) -> bool:
        return bool(self._with("filter_batch"))

    def has_batch_scores(self) -> bool:
        return bool(self._with("score_batch"))

    def run_prefilter(self, state: CycleState, pod: Pod) -> Status:
        for p in self._with("pre_filter"):
            s = status_of(p.pre_filter(state, pod))
            if not s.is_success():
                return Status(s.code, f"prefilter plugin {p.name()}: {s.message}")
        return Status()

    def run_host_filter(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        for p in self._with("filter"):
            s = status_of(p.filter(state, pod, node_name))
            if not s.is_success():
                return s
        return Status()

    def run_host_score(self, state: CycleState, pod: Pod, node_name: str) -> float:
        total = 0.0
        for p in self._with("score"):
            val, s = p.score(state, pod, node_name)
            if not status_of(s).is_success():
                raise RuntimeError(
                    f"score plugin {p.name()} failed: {status_of(s).message}"
                )
            w = p.score_weight() if hasattr(p, "score_weight") else 1.0
            total += w * val
        return total

    def run_filter_batch(self, state: CycleState, dp, dn, ds):
        """AND of all device filter plugins' masks; None when there are
        none (so the solver skips the combine)."""
        mask = None
        for p in self._with("filter_batch"):
            m = p.filter_batch(state, dp, dn, ds)
            mask = m if mask is None else (mask & m)
        return mask

    def run_score_batch(self, state: CycleState, dp, dn, ds):
        total = None
        for p in self._with("score_batch"):
            w = p.score_weight() if hasattr(p, "score_weight") else 1.0
            s = w * p.score_batch(state, dp, dn, ds)
            total = s if total is None else total + s
        return total

    # -- transactional points ---------------------------------------------

    def run_reserve(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        for p in self._with("reserve"):
            s = status_of(p.reserve(state, pod, node_name))
            if not s.is_success():
                return Status(ERROR, f"reserve plugin {p.name()}: {s.message}")
        return Status()

    def run_permit(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        """framework.go RunPermitPlugins: any Error/Unschedulable rejects;
        any Wait (with the max timeout) parks the pod in the waiting map —
        the caller must then check ``waiting`` before binding."""
        max_timeout = 0.0
        pending_wait = False
        for p in self._with("permit"):
            s, timeout = p.permit(state, pod, node_name)
            s = status_of(s)
            if s.code in (ERROR, UNSCHEDULABLE):
                return Status(s.code, f"permit plugin {p.name()}: {s.message}")
            if s.code == WAIT:
                pending_wait = True
                max_timeout = max(max_timeout, float(timeout))
        if pending_wait:
            self.waiting.add(
                WaitingPod(pod=pod, node_name=node_name,
                           deadline=self.clock() + max_timeout)
            )
            return Status(WAIT, "waiting on permit")
        return Status()

    def run_prebind(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        for p in self._with("pre_bind"):
            s = status_of(p.pre_bind(state, pod, node_name))
            if not s.is_success():
                return Status(ERROR, f"prebind plugin {p.name()}: {s.message}")
        return Status()

    def run_bind(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        """First bind plugin that doesn't Skip handles the pod
        (interface.go:236-241); Skip from all = caller uses the default
        binder."""
        for p in self._with("bind"):
            s = status_of(p.bind(state, pod, node_name))
            if s.code == SKIP:
                continue
            return s
        return Status(SKIP, "no bind plugin handled the pod")

    def run_postbind(self, state: CycleState, pod: Pod, node_name: str) -> None:
        for p in self._with("post_bind"):
            p.post_bind(state, pod, node_name)

    def run_unreserve(self, state: CycleState, pod: Pod, node_name: str) -> None:
        for p in self._with("unreserve"):
            p.unreserve(state, pod, node_name)
