"""Host-side volume state + per-pod volume resolution.

The reference spreads volume feasibility over five predicates
(``pkg/scheduler/algorithm/predicates/predicates.go``):

- NoDiskConflict (:275) — inline GCE-PD/EBS/RBD/ISCSI volumes conflicting
  with volumes of pods already on the node,
- MaxPDVolumeCountChecker (:404) — unique EBS/GCE-PD/AzureDisk/Cinder
  volumes vs a per-node attach limit,
- CSIMaxVolumeLimitChecker (csi_volume_predicate.go:54) — per-CSI-driver
  counts vs ``attachable-volumes-csi-<driver>`` allocatable,
- VolumeZoneChecker (:632) — bound PVs' failure-domain labels must match
  the node's,
- VolumeBindingChecker (:1666) — bound PVCs' PV node affinity satisfied;
  unbound delayed-binding PVCs matchable to an available compatible PV (or
  dynamically provisionable).

Here all five resolve host-side into token sets / constraint rows (this
module) that the fused device kernel evaluates as masked matmuls and
segment reductions over the (pods x nodes) grid
(``kubernetes_tpu_torch.ops.predicates``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from kubernetes_tpu_torch.api.types import (
    BINDING_WAIT_FOR_FIRST_CONSUMER,
    VOL_AWS_EBS,
    VOL_AZURE_DISK,
    VOL_CINDER,
    VOL_CSI,
    VOL_GCE_PD,
    VOL_ISCSI,
    VOL_RBD,
    Node,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    StorageClass,
)

# ---------------------------------------------------------------------------
# Attach-limit constants — pkg/volume/util/attach_limit.go:28-51 and
# predicates.go DefaultMaxGCEPDVolumes/DefaultMaxAzureDiskVolumes.
# ---------------------------------------------------------------------------

DEFAULT_MAX_EBS_VOLUMES = 39
DEFAULT_MAX_EBS_NITRO_VOLUMES = 25
DEFAULT_MAX_GCE_PD_VOLUMES = 16
DEFAULT_MAX_AZURE_DISK_VOLUMES = 16
DEFAULT_MAX_CINDER_VOLUMES = 256

EBS_NITRO_RE = re.compile(r"^[cmr]5.*|t3|z1d")
LABEL_INSTANCE_TYPE = "beta.kubernetes.io/instance-type"

#: the four in-tree count-checked volume kinds, in fixed column order
PD_FILTER_KINDS = (VOL_AWS_EBS, VOL_GCE_PD, VOL_AZURE_DISK, VOL_CINDER)
PD_FILTER_INDEX = {k: i for i, k in enumerate(PD_FILTER_KINDS)}
N_PD_FILTERS = len(PD_FILTER_KINDS)

#: allocatable keys overriding the defaults (AttachVolumeLimit feature)
PD_LIMIT_KEYS = (
    "attachable-volumes-aws-ebs",
    "attachable-volumes-gce-pd",
    "attachable-volumes-azure-disk",
    "attachable-volumes-cinder",
)
CSI_LIMIT_PREFIX = "attachable-volumes-csi-"

#: conflict kinds; value = read-only mounts escape the conflict
#: (isVolumeConflict, predicates.go:216: GCE/ISCSI/RBD yes, EBS no)
CONFLICT_RO_ESCAPE = {
    VOL_GCE_PD: True,
    VOL_AWS_EBS: False,
    VOL_ISCSI: True,
    VOL_RBD: True,
}

LABEL_ZONE = "failure-domain.beta.kubernetes.io/zone"
LABEL_REGION = "failure-domain.beta.kubernetes.io/region"


def node_pd_limits(node: Node) -> List[float]:
    """Per-node attach limits for the four in-tree kinds
    (getMaxVolumeFunc predicates.go:354 + allocatable override :505-510)."""
    out: List[float] = []
    itype = node.labels.get(LABEL_INSTANCE_TYPE, "")
    for i, kind in enumerate(PD_FILTER_KINDS):
        if kind == VOL_AWS_EBS:
            dflt = (
                DEFAULT_MAX_EBS_NITRO_VOLUMES
                if EBS_NITRO_RE.match(itype)
                else DEFAULT_MAX_EBS_VOLUMES
            )
        elif kind == VOL_GCE_PD:
            dflt = DEFAULT_MAX_GCE_PD_VOLUMES
        elif kind == VOL_AZURE_DISK:
            dflt = DEFAULT_MAX_AZURE_DISK_VOLUMES
        else:
            dflt = DEFAULT_MAX_CINDER_VOLUMES
        out.append(float(node.allocatable.scalars.get(PD_LIMIT_KEYS[i], dflt)))
    return out


def node_has_zone_label(node: Node) -> bool:
    """VolumeZoneChecker fast path (predicates.go:644-658): a node with
    neither failure-domain label passes every zone constraint."""
    return LABEL_ZONE in node.labels or LABEL_REGION in node.labels


def label_zones_to_set(value: str) -> Tuple[str, ...]:
    """cloud-provider volumehelpers.LabelZonesToSet: '__'-delimited list."""
    return tuple(z for z in value.split("__") if z)


def _match_requirement(labels: Dict[str, str], req) -> bool:
    """v1helper.MatchNodeSelectorTerms requirement evaluation."""
    val = labels.get(req.key)
    op = req.operator
    if op == "In":
        return val is not None and val in req.values
    if op == "NotIn":
        return val is None or val not in req.values
    if op == "Exists":
        return req.key in labels
    if op == "DoesNotExist":
        return req.key not in labels
    if op in ("Gt", "Lt"):
        try:
            lhs = int(val) if val is not None else None
            rhs = int(req.values[0])
        except (TypeError, ValueError):
            return False
        if lhs is None:
            return False
        return lhs > rhs if op == "Gt" else lhs < rhs
    return False


def match_node_selector_terms(labels: Dict[str, str], terms) -> bool:
    """ORed NodeSelectorTerms, each ANDing its requirements — how a PV's
    node affinity is checked against a node (VolumeBindingChecker,
    predicates.go:1666 → volumeutil.CheckNodeAffinity). A term with no
    match_expressions matches NOTHING (apimachinery nodeSelectorTerm
    semantics — same rule the seqref oracle's _term_matches documents;
    deliberately re-implemented here because seqref stays test-only)."""
    return any(
        bool(term.match_expressions)
        and all(_match_requirement(labels, r) for r in term.match_expressions)
        for term in terms
    )


@dataclass
class VolumeState:
    """The PVC/PV/StorageClass listers the volume predicates consult —
    the analog of the informer-fed PersistentVolume{,Claim}Info /
    StorageClassInfo caches (predicates.go:127-205)."""

    pvcs: Dict[Tuple[str, str], PersistentVolumeClaim] = field(default_factory=dict)
    pvs: Dict[str, PersistentVolume] = field(default_factory=dict)
    classes: Dict[str, StorageClass] = field(default_factory=dict)
    #: pv name -> "ns/name" of the claim the scheduler has ASSUMED onto it
    #: (the binder's pvCache assume overlay): reserved but not yet written
    assumed_claims: Dict[str, str] = field(default_factory=dict)

    @staticmethod
    def build(
        pvcs: Sequence[PersistentVolumeClaim] = (),
        pvs: Sequence[PersistentVolume] = (),
        classes: Sequence[StorageClass] = (),
    ) -> "VolumeState":
        return VolumeState(
            pvcs={(c.namespace, c.name): c for c in pvcs},
            pvs={v.name: v for v in pvs},
            classes={c.name: c for c in classes},
        )

    def pvc(self, namespace: str, name: str) -> Optional[PersistentVolumeClaim]:
        return self.pvcs.get((namespace, name))

    def pv(self, name: str) -> Optional[PersistentVolume]:
        return self.pvs.get(name)

    def storage_class(self, name: str) -> Optional[StorageClass]:
        return self.classes.get(name)

    def available_pvs(self, storage_class: str) -> List[PersistentVolume]:
        """Candidate PVs for an unbound delayed-binding claim: unclaimed and
        of the same storage class (the shape-level model of the binder's
        findMatchingVolumes; capacity/access-mode matching is out of scope
        for scheduling parity)."""
        return [
            pv
            for pv in self.pvs.values()
            if not pv.claim_ref
            and not getattr(pv, "deletion_timestamp", 0.0)
            and pv.name not in self.assumed_claims
            and pv.storage_class == storage_class
        ]


@dataclass
class ResolvedVolumes:
    """Everything the kernels need to know about one pod's volumes."""

    #: (kind, handle, read_only) for inline conflict-checked volumes
    conflict: List[Tuple[str, str, bool]] = field(default_factory=list)
    #: (filter_idx, token) unique count-checked volumes; ``token`` is
    #: "h:<handle>" for resolved volumes and "pvc:<ns>/<name>" for
    #: missing/unbound claims (counted against EVERY filter, matching the
    #: per-checker random-prefix pseudo-ids, predicates.go:414)
    pd: List[Tuple[int, str]] = field(default_factory=list)
    #: (driver, handle) CSI volumes (bound PVC -> CSI PV only)
    csi: List[Tuple[str, str]] = field(default_factory=list)
    #: zone rows: (label_key, allowed_values) — node must carry one of the
    #: allowed (key, value) labels unless it has no zone labels at all
    zone_rows: List[Tuple[str, Tuple[str, ...]]] = field(default_factory=list)
    #: bound-PV node-affinity requirements: each entry = one PV's ORed
    #: NodeSelectorTerm tuple (AND across entries)
    bound_affinity: List[Tuple] = field(default_factory=list)
    #: unbound delayed-binding clauses: each entry = list of candidate PVs'
    #: node-affinity term tuples (OR within, AND across entries); an entry
    #: may be empty = no candidate at all -> unbound-unsatisfiable
    unbound_clauses: List[List[Tuple]] = field(default_factory=list)
    #: unresolvable volume state -> scheduling error, pod fails everywhere
    #: (predicate errors abort the pod's cycle in the reference)
    error: bool = False


def resolve_pod_volumes(pod: Pod, state: VolumeState) -> ResolvedVolumes:
    """Resolve a pod's volumes through PVC -> PV with the reference's exact
    missing/unbound fallbacks (see per-field docs above)."""
    out = ResolvedVolumes()
    for v in pod.volumes:
        if not v.pvc:
            if v.kind in CONFLICT_RO_ESCAPE:
                out.conflict.append((v.kind, v.handle, v.read_only))
            fi = PD_FILTER_INDEX.get(v.kind)
            if fi is not None:
                out.pd.append((fi, "h:" + v.handle))
            continue
        pvc = state.pvc(pod.namespace, v.pvc)
        if pvc is None:
            # missing claim: scheduling error (podPassesBasicChecks /
            # CSI + zone checkers error out); still counted per checker
            out.error = True
            tok = f"pvc:{pod.namespace}/{v.pvc}"
            out.pd.extend((i, tok) for i in range(N_PD_FILTERS))
            continue
        if not pvc.volume_name:
            # unbound claim
            tok = f"pvc:{pod.namespace}/{v.pvc}"
            out.pd.extend((i, tok) for i in range(N_PD_FILTERS))
            sc = state.storage_class(pvc.storage_class) if pvc.storage_class else None
            if sc is not None and sc.binding_mode == BINDING_WAIT_FOR_FIRST_CONSUMER:
                # delayed binding: satisfiable via an available compatible
                # PV's node affinity, or dynamic provisioning
                if sc.provisionable():
                    continue  # clause trivially satisfiable -> omit
                cands = [pv.node_affinity for pv in state.available_pvs(pvc.storage_class)]
                out.unbound_clauses.append([tuple(t) for t in cands])
            else:
                # unbound immediate claim: "pod has unbound immediate
                # PersistentVolumeClaims" scheduling error
                out.error = True
            continue
        pv = state.pv(pvc.volume_name)
        if pv is None:
            # bound claim whose PV vanished: error (VolumeZone/binder);
            # counted per checker like an unknown volume
            out.error = True
            tok = f"pvc:{pod.namespace}/{v.pvc}"
            out.pd.extend((i, tok) for i in range(N_PD_FILTERS))
            continue
        for akind, a, b in attachable_tokens(pv):
            if akind == "pd":
                out.pd.append((a, b))
            else:
                out.csi.append((a, b))
        for k in (LABEL_ZONE, LABEL_REGION):
            val = pv.labels.get(k)
            if val:
                allowed = label_zones_to_set(val)
                if allowed:
                    out.zone_rows.append((k, allowed))
        if pv.node_affinity:
            out.bound_affinity.append(tuple(pv.node_affinity))
    # dedup count tokens (filterVolumes collects into a set)
    out.pd = sorted(set(out.pd))
    out.csi = sorted(set(out.csi))
    return out


def attachable_tokens(pv) -> list:
    """The ONE PV -> attach-token classification (shared by
    resolve_pod_volumes' bound-claim branch, the snapshot packer's
    residue columns, and the attach-detach controller's desired-state
    scan — three consumers that must never skew): a list of
    ``("pd", filter_index, "h:"+handle)`` and/or
    ``("csi", driver, handle)`` entries; empty = not attachable."""
    out = []
    fi = PD_FILTER_INDEX.get(pv.kind)
    if fi is not None:
        out.append(("pd", fi, "h:" + pv.handle))
    if pv.kind == VOL_CSI and pv.driver:
        out.append(("csi", pv.driver, pv.handle))
    return out


class VolumeBinder:
    """The delayed-binding PVC lifecycle inside the scheduling flow — the
    analog of ``pkg/scheduler/volumebinder/volume_binder.go:30`` wrapping
    the volume scheduling library:

    - :meth:`assume_pod_volumes` (scheduler.go:523 assumeVolumes →
      AssumePodVolumes): at assume time, pick ONE available compatible PV
      per unbound WaitForFirstConsumer claim for the chosen node and
      reserve it in the assumed overlay, so no concurrent claimant —
      in-batch or next-cycle — can take it;
    - :meth:`bind_pod_volumes` (scheduler.go:550 bindVolumes →
      BindPodVolumes): commit the reserved claims (PV.claimRef +
      PVC.volumeName) through ``writer`` — an API write in a real
      deployment, injectable so tests/sims can make it conflict;
    - :meth:`forget_pod_volumes`: roll back reservations whenever the pod's
      assumption is forgotten (Permit reject/timeout, bind failure,
      deletion while parked).
    """

    def __init__(self, packer, writer=None) -> None:
        self.packer = packer
        self.writer = writer or self._local_write
        #: pod key -> [(pvc, pv)] reserved picks awaiting bind
        self.assumed: Dict[str, List[Tuple[PersistentVolumeClaim, PersistentVolume]]] = {}

    @property
    def state(self) -> VolumeState:
        return self.packer.vol_state

    def _local_write(self, pvc: PersistentVolumeClaim, pv: PersistentVolume) -> None:
        """Default commit: mutate the local listers (the sim hub's truth)."""
        pv.claim_ref = f"{pvc.namespace}/{pvc.name}"
        pvc.volume_name = pv.name

    def assume_pod_volumes(self, pod: Pod, node: Node) -> Tuple[bool, str]:
        """Returns (ok, message). ok=True with no reservations made is the
        reference's allBound=true fast path."""
        if not any(v.pvc for v in pod.volumes):
            return True, ""
        if pod.key() in self.assumed:
            # reservation already held (e.g. a Permit-parked pod popped
            # again via a duplicate queue entry) — re-assuming would
            # overwrite and leak the prior picks
            return True, ""
        st = self.state
        picks: List[Tuple[PersistentVolumeClaim, PersistentVolume]] = []

        def rollback() -> None:
            for _, pv in picks:
                st.assumed_claims.pop(pv.name, None)

        for v in pod.volumes:
            if not v.pvc:
                continue
            pvc = st.pvc(pod.namespace, v.pvc)
            if pvc is None:
                rollback()
                return False, f'persistentvolumeclaim "{v.pvc}" not found'
            if pvc.volume_name:
                continue  # already bound
            sc = st.storage_class(pvc.storage_class) if pvc.storage_class else None
            if sc is None or sc.binding_mode != BINDING_WAIT_FOR_FIRST_CONSUMER:
                rollback()
                return False, f'pod has unbound immediate PersistentVolumeClaims ("{v.pvc}")'
            if sc.provisionable():
                continue  # dynamic provisioning satisfies it post-bind
            cand = None
            for pv in st.available_pvs(pvc.storage_class):
                if not pv.node_affinity or match_node_selector_terms(
                    node.labels, pv.node_affinity
                ):
                    cand = pv
                    break
            if cand is None:
                rollback()
                return False, (
                    f'no matching PersistentVolume for claim "{v.pvc}" on '
                    f'node "{node.name}"'
                )
            st.assumed_claims[cand.name] = f"{pod.namespace}/{pvc.name}"
            picks.append((pvc, cand))
        if picks:
            self.assumed[pod.key()] = picks
            self.packer.refresh_volume_resolutions()
        return True, ""

    def bind_pod_volumes(self, pod: Pod) -> bool:
        """Commit reserved claims. Returns True if any write happened.
        A writer failure releases the remaining reservations and re-raises
        (the pod is then Forgotten + requeued; already-committed claims
        stay bound, exactly like real API writes that landed — the next
        attempt sees those PVCs bound and only assumes the rest)."""
        picks = self.assumed.pop(pod.key(), None)
        if not picks:
            return False
        st = self.state
        try:
            for pvc, pv in picks:
                self.writer(pvc, pv)
                st.assumed_claims.pop(pv.name, None)
        except Exception:
            for pvc, pv in picks:
                if pvc.volume_name != pv.name:  # not committed
                    st.assumed_claims.pop(pv.name, None)
            self.packer.refresh_volume_resolutions()
            raise
        self.packer.refresh_volume_resolutions()
        return True

    def forget_pod_volumes(self, pod_key: str) -> None:
        picks = self.assumed.pop(pod_key, None)
        if picks:
            for _, pv in picks:
                self.state.assumed_claims.pop(pv.name, None)
            self.packer.refresh_volume_resolutions()
