"""Test object builders — the analog of the reference's
``pkg/scheduler/testing/wrappers.go`` pod/node wrappers used throughout its
unit suites."""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

from kubernetes_tpu_torch.api.types import (
    Affinity,
    LabelSelector,
    Node,
    NodeCondition,
    NodeSelectorTerm,
    Pod,
    PodDisruptionBudget,
    PreferredSchedulingTerm,
    Requirement,
    Resources,
    Taint,
    Toleration,
    TopologySpreadConstraint,
)


def make_node(
    name: str,
    cpu_milli: float = 32000,
    memory: float = 64 * 2**30,
    pods: int = 110,
    labels: Optional[Dict[str, str]] = None,
    taints: Sequence[Taint] = (),
    zone: Optional[str] = None,
    **kw,
) -> Node:
    labels = dict(labels or {})
    labels.setdefault("kubernetes.io/hostname", name)
    if zone is not None:
        labels["failure-domain.beta.kubernetes.io/zone"] = zone
    return Node(
        name=name,
        labels=labels,
        allocatable=Resources(cpu_milli=cpu_milli, memory=memory, pods=pods),
        taints=tuple(taints),
        **kw,
    )


def make_pod(
    name: str,
    cpu_milli: float = 0,
    memory: float = 0,
    namespace: str = "default",
    node_name: str = "",
    labels: Optional[Dict[str, str]] = None,
    node_selector: Optional[Dict[str, str]] = None,
    affinity: Optional[Affinity] = None,
    tolerations: Sequence[Toleration] = (),
    priority: int = 0,
    host_ports: Sequence[Tuple[str, str, int]] = (),
    scalars: Optional[Dict[str, float]] = None,
    **kw,
) -> Pod:
    return Pod(
        name=name,
        namespace=namespace,
        node_name=node_name,
        labels=dict(labels or {}),
        node_selector=dict(node_selector or {}),
        affinity=affinity or Affinity(),
        tolerations=tuple(tolerations),
        priority=priority,
        requests=Resources(cpu_milli=cpu_milli, memory=memory, scalars=dict(scalars or {})),
        host_ports=tuple(host_ports),
        **kw,
    )


def req(key: str, op: str, *values: str) -> Requirement:
    return Requirement(key=key, operator=op, values=tuple(values))


def node_affinity_required(*terms: Sequence[Requirement]) -> Affinity:
    return Affinity(
        node_required=tuple(NodeSelectorTerm(tuple(t)) for t in terms)
    )


def node_affinity_preferred(*weighted: Tuple[int, Sequence[Requirement]]) -> Affinity:
    return Affinity(
        node_preferred=tuple(
            PreferredSchedulingTerm(weight=w, preference=NodeSelectorTerm(tuple(t)))
            for w, t in weighted
        )
    )


def make_pdb(name: str, match_labels: Dict[str, str],
             disruptions_allowed: int = 0,
             namespace: str = "default") -> PodDisruptionBudget:
    """A PodDisruptionBudget over the pods carrying ``match_labels``, with
    ``disruptions_allowed`` as its status."""
    return PodDisruptionBudget(
        name=name, namespace=namespace,
        selector=LabelSelector(match_labels=dict(match_labels)),
        disruptions_allowed=disruptions_allowed)


def lint_clean(
    source,
    rules: Sequence[str] = ("R1", "R2", "R3", "R5", "R6"),
    filename: str = "<kernel>",
    capture_all: bool = True,
) -> None:
    """Assert a round program's or kernel's source passes the port's
    graftlint — the capture-safety analog of the wrappers above: a new
    ops module pins its own discipline with one line in its unit test::

        from kubernetes_tpu_torch.testing import lint_clean
        import kubernetes_tpu_torch.ops.mykernel as mk
        def test_mykernel_capture_safe():
            lint_clean(mk)

    ``source`` is a source string, a module, or any object
    ``inspect.getsource`` accepts (function, class). ``capture_all=True``
    treats every *uncalled* top-level function as a capture root (its
    positional parameters tensors, ``first``/``tag`` and keyword-only
    parameters host), so the check covers round programs whose
    ``device_loop.run`` call lives in the caller; helpers the source
    itself calls are judged by their real call-site taint. Pass
    ``capture_all=False`` for modules that mix round programs with
    deliberate host-side functions (``ops/assign.py``'s trust-but-verify
    ``validate_solution``) to lint via the module's real ``device_loop.run``
    roots. The default rule set is the device-side discipline (capture
    safety, host syncs, re-capture, dtype); pass ``rules=None`` for
    everything.

    Raises AssertionError listing every finding; returns None when clean.
    """
    import inspect
    import os

    from kubernetes_tpu_torch.lint import lint_source
    from kubernetes_tpu_torch.lint.report import render_text

    if not isinstance(source, str):
        filename = getattr(source, "__file__", None) or filename
        source = inspect.getsource(source)
    # R5 scopes by path: make bare snippet names look like ops/ files so
    # the dtype rule engages for kernel sources passed as strings
    if "/" not in filename.replace(os.sep, "/"):
        filename = f"ops/{filename.lstrip('<').rstrip('>') or 'kernel'}.py"
    # R6 is always on: every OTHER rule is vacuous on source that does
    # not parse, so without the syntax gate a broken kernel would pass
    select = tuple(dict.fromkeys(tuple(rules) + ("R6",))) \
        if rules is not None else None
    findings = lint_source(
        source, filename=filename, select=select, capture_all=capture_all,
    )
    if findings:
        raise AssertionError(
            "graftlint found capture-safety problems:\n"
            + render_text(findings)
        )
