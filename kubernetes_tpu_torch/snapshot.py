"""Columnar cluster snapshot — the tensor form of the reference's scheduler
cache snapshot.

The reference keeps per-node ``NodeInfo`` structs (requested/allocatable
resources, pods, used ports, taints, image states —
``pkg/scheduler/nodeinfo/node_info.go:50,:146``) and re-snapshots them
incrementally each cycle (``internal/cache/cache.go:211``
UpdateNodeInfoSnapshot). Here the snapshot is *columnar*: one dense array per
attribute across all nodes, plus multihot membership matrices for every
string-set attribute (label pairs, taint ids, port ids, image ids), so that
per-(pod,node) set intersections evaluate as integer matmuls on the MXU.

Ragged selector logic (nodeSelector maps, NodeAffinity requirement trees) is
compiled host-side into flat **expression tables** over a *selector-program*
universe: each distinct selector structure is interned once, its expressions
are rows of fixed-shape arrays, and the device evaluates all programs against
all nodes with segment reductions (AND within term, OR across terms). Pods
then just gather their program's row — deduplicating the (very common) case
of thousands of pods sharing one pod-template's selector.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kubernetes_tpu_torch.api.types import (
    EFFECT_NO_EXECUTE,
    EFFECT_NO_SCHEDULE,
    EFFECT_PREFER_NO_SCHEDULE,
    OP_DOES_NOT_EXIST,
    OP_EXISTS,
    OP_GT,
    OP_IN,
    OP_LT,
    OP_NOT_IN,
    Affinity,
    LabelSelector,
    Node,
    NodeSelectorTerm,
    Pod,
    Requirement,
    Resources,
    Toleration,
)
from kubernetes_tpu_torch.utils.interner import Interner, bucket_size
from kubernetes_tpu_torch.volumes import (
    CONFLICT_RO_ESCAPE,
    CSI_LIMIT_PREFIX,
    N_PD_FILTERS,
    ResolvedVolumes,
    VolumeState,
    node_has_zone_label,
    node_pd_limits,
    resolve_pod_volumes,
)

# Fixed resource columns; scalar/extended resources append after these.
# Mirrors nodeinfo.Resource (node_info.go:146).
RES_CPU, RES_MEM, RES_EPH, RES_PODS = 0, 1, 2, 3
N_FIXED_RESOURCES = 4
#: column names in RES_* order (events/FitError text; scalars append after)
FIXED_RESOURCE_NAMES = ("cpu", "memory", "ephemeral-storage", "pods")

# Expression opcodes for the device-side selector interpreter.
XOP_IN, XOP_NOT_IN, XOP_EXISTS, XOP_NOT_EXISTS, XOP_GT, XOP_LT = range(6)

#: Go strconv.ParseInt-compatible integer syntax (ASCII digits, optional sign)
_GO_INT_RE = re.compile(r"^[+-]?[0-9]+$")

_OPCODE = {
    OP_IN: XOP_IN,
    OP_NOT_IN: XOP_NOT_IN,
    OP_EXISTS: XOP_EXISTS,
    OP_DOES_NOT_EXIST: XOP_NOT_EXISTS,
    OP_GT: XOP_GT,
    OP_LT: XOP_LT,
}

# Sym-term kinds: the three classes of an *existing* pod's affinity terms
# that score the incoming pod by symmetry
# (priorities/interpod_affinity.go:46 CalculateInterPodAffinityPriority):
# required affinity (weight = hardPodAffinityWeight), preferred affinity
# (+w), preferred anti-affinity (-w).
SYM_HARD_AFF, SYM_SOFT_AFF, SYM_SOFT_ANTI = 0, 1, 2


def _canon_selector(sel: LabelSelector):
    return (
        tuple(sorted(sel.match_labels.items())),
        tuple((r.key, r.operator, tuple(r.values)) for r in sel.match_expressions),
    )


@dataclass(frozen=True)
class CompiledExpr:
    op: int
    pair_ids: Tuple[int, ...] = ()  # In/NotIn: interned (key,value) ids
    key_id: int = -1  # Exists/DoesNotExist/Gt/Lt: interned key id
    literal: float = 0.0  # Gt/Lt


class Universe:
    """All interning state shared across snapshots. Grows monotonically;
    device-side arrays are padded to power-of-two buckets so growth rarely
    changes compiled shapes."""

    def __init__(self) -> None:
        self.node_names = Interner()
        self.scalar_resources = Interner()
        self.label_pairs = Interner()  # (key, value) referenced by selectors
        self.label_keys = Interner()  # keys referenced by Exists/DNE/Gt/Lt
        self.taints = Interner()  # (key, value, effect)
        self.ports_pp = Interner()  # (protocol, port)
        self.ports_pip = Interner()  # (protocol, hostIP, port), ip != wildcard
        self.images = Interner()  # image name
        self.image_sizes: List[float] = []
        # selector programs: canonical repr -> id; terms[i] = list of terms,
        # each term a list of CompiledExpr (AND within term, OR across terms)
        self.sel_programs = Interner()
        self.sel_program_terms: List[List[List[CompiledExpr]]] = []
        # preferred programs: list of (weight, [CompiledExpr]) terms (summed)
        self.pref_programs = Interner()
        self.pref_program_terms: List[List[Tuple[float, List[CompiledExpr]]]] = []
        # toleration sets
        self.tol_sets = Interner()
        self.tol_set_items: List[Tuple[Toleration, ...]] = []
        # owner-selector sets (SelectorSpread) — (namespace, canonical sels)
        self.owner_sets = Interner()
        self.owner_set_items: List[Tuple[str, tuple]] = []
        # zone keys (region, zone) — SelectorSpread zone weighting
        self.zones = Interner()
        # controller owner UIDs — NodePreferAvoidPods
        self.owner_uids = Interner()
        # ---- inter-pod affinity / topology spread universes --------------
        # (tensor form of predicates/metadata.go topologyPairsMaps :65)
        self.topo_keys = Interner()  # topology key strings
        self.topo_pairs = Interner()  # (key_id, value)
        # pod matchers: (namespaces-or-None, canonical selector) evaluated
        # against POD labels — shared by affinity terms & spread constraints
        self.pod_matchers = Interner()
        self.pod_matcher_items: List[Tuple[Optional[Tuple[str, ...]], LabelSelector]] = []
        # required (anti)affinity programs: rows (key_id, matcher_id, is_anti)
        self.aff_programs = Interner()
        self.aff_program_rows: List[List[Tuple[int, int, bool]]] = []
        # preferred (anti)affinity programs: rows (key_id, matcher_id, ±weight)
        self.pref_aff_programs = Interner()
        self.pref_aff_program_rows: List[List[Tuple[int, int, float]]] = []
        # distinct required anti-affinity terms of ANY pod — the symmetry
        # check (satisfiesExistingPodsAntiAffinity, predicates.go:~1400)
        self.anti_terms = Interner()  # (key_id, matcher_id)
        # distinct symmetric scoring terms: (key_id, matcher_id, weight, kind)
        self.sym_terms = Interner()
        # topology-spread programs: (rows, selprog_id); candidacy of a node
        # depends on the pod's node selector (metadata.go:232)
        self.spread_hard_programs = Interner()  # rows (key, matcher, maxSkew)
        self.spread_hard_program_rows: List[Tuple[Tuple[Tuple[int, int, int], ...], int]] = []
        self.spread_soft_programs = Interner()  # rows (key, matcher)
        self.spread_soft_program_rows: List[Tuple[Tuple[Tuple[int, int], ...], int]] = []
        # ---- volume universes (kubernetes_tpu_torch.volumes) -------------------
        self.vol_conflict = Interner()  # (kind, handle) — NoDiskConflict tokens
        self.vol_conflict_escape: List[bool] = []  # read-only escape per token
        self.pd_volumes = Interner()  # (filter_idx, token) — MaxPDVolumeCount
        self.csi_drivers = Interner()  # CSI driver names
        self.csi_volumes = Interner()  # (driver_id, handle)
        # ---- label-fingerprint memos (pack-time hot path) ----------------
        # pods overwhelmingly share label sets (every pod of one RS /
        # service carries identical labels), so matcher and owner-set
        # evaluation memoizes on (ns, sorted labels); registry LENGTH in
        # the key invalidates when new matchers/sets are interned. The
        # TPU headline measured packing at 17% of wall — these two memos
        # are most of the selector-evaluation half of that.
        self._matcher_row_memo: Dict[tuple, np.ndarray] = {}
        self._owner_sets_memo: Dict[tuple, List[int]] = {}

    # -- resources ---------------------------------------------------------

    def n_resources(self) -> int:
        return N_FIXED_RESOURCES + len(self.scalar_resources)

    def resource_vector(self, r: Resources, out_len: Optional[int] = None) -> np.ndarray:
        for name in r.scalars:
            self.scalar_resources.intern(name)
        n = out_len or self.n_resources()
        v = np.zeros((n,), np.float32)
        v[RES_CPU] = r.cpu_milli
        v[RES_MEM] = r.memory
        v[RES_EPH] = r.ephemeral_storage
        v[RES_PODS] = r.pods
        for name, q in r.scalars.items():
            v[N_FIXED_RESOURCES + self.scalar_resources.intern(name)] = q
        return v

    # -- selector compilation ---------------------------------------------

    def _compile_requirement(self, r: Requirement) -> CompiledExpr:
        op = _OPCODE[r.operator]
        if op in (XOP_IN, XOP_NOT_IN):
            pair_ids = tuple(self.label_pairs.intern((r.key, v)) for v in r.values)
            return CompiledExpr(op=op, pair_ids=pair_ids)
        key_id = self.label_keys.intern(r.key)
        lit = 0.0
        if op in (XOP_GT, XOP_LT):
            v = r.values[0] if r.values else ""
            if not _GO_INT_RE.match(v):
                # unparsable Gt/Lt literal: the reference's selector
                # conversion errors and the term matches nothing — encode
                # as an unsatisfiable In-set, never crash the pack
                return CompiledExpr(op=XOP_IN, pair_ids=())
            lit = float(int(v))
        return CompiledExpr(op=op, key_id=key_id, literal=lit)

    def _compile_term(self, term: NodeSelectorTerm) -> List[CompiledExpr]:
        return [self._compile_requirement(r) for r in term.match_expressions]

    def intern_node_selector_program(
        self, node_selector: Dict[str, str], affinity: Affinity
    ) -> int:
        """Compile a pod's required node-selection (spec.nodeSelector AND
        RequiredDuringScheduling node affinity) into one program id.

        Semantics follow predicates.PodMatchNodeSelector
        (predicates.go:904 -> podMatchesNodeSelectorAndAffinityTerms):
        nodeSelector map is AND of equality pairs; affinity required terms
        are ORed, each term AND of expressions; both must pass.
        """
        terms: List[List[CompiledExpr]] = []
        base: List[CompiledExpr] = [
            self._compile_requirement(Requirement(k, OP_IN, (v,)))
            for k, v in sorted(node_selector.items())
        ]
        if affinity.node_required:
            for t in affinity.node_required:
                # an empty NodeSelectorTerm matches NO objects (apimachinery
                # helpers: "nil or empty term matches no objects") — skip it
                # rather than letting `base` alone stand in for the branch
                if t.match_expressions:
                    terms.append(base + self._compile_term(t))
            if not terms:
                # required affinity present but every term empty: the pod
                # can match nothing — emit one unsatisfiable term (empty
                # In-set evaluates false on every node)
                terms.append([CompiledExpr(op=XOP_IN, pair_ids=())])
        elif base:
            terms.append(base)
        if not terms:
            return -1
        key = tuple(
            tuple((e.op, e.pair_ids, e.key_id, e.literal) for e in t) for t in terms
        )
        pid = self.sel_programs.intern(key)
        if pid == len(self.sel_program_terms):
            self.sel_program_terms.append(terms)
        return pid

    def intern_preferred_program(self, affinity: Affinity) -> int:
        """PreferredDuringScheduling node affinity -> weighted term list
        (priorities/node_affinity.go: score = sum of weights of matched
        terms, then NormalizeReduce to 0-10)."""
        if not affinity.node_preferred:
            return -1
        terms = [
            (float(p.weight), self._compile_term(p.preference))
            for p in affinity.node_preferred
            if p.weight > 0 and p.preference.match_expressions
        ]
        if not terms:
            return -1
        key = tuple(
            (w, tuple((e.op, e.pair_ids, e.key_id, e.literal) for e in t))
            for w, t in terms
        )
        pid = self.pref_programs.intern(key)
        if pid == len(self.pref_program_terms):
            self.pref_program_terms.append(terms)
        return pid

    # -- tolerations -------------------------------------------------------

    def intern_toleration_set(self, tolerations: Tuple[Toleration, ...]) -> int:
        if not tolerations:
            return -1
        key = tuple(
            (t.key, t.operator, t.value, t.effect) for t in tolerations
        )
        tid = self.tol_sets.intern(key)
        if tid == len(self.tol_set_items):
            self.tol_set_items.append(tuple(tolerations))
        return tid

    def intern_taint(self, key: str, value: str, effect: str) -> int:
        return self.taints.intern((key, value, effect))

    def intern_image(self, name: str, size: float) -> int:
        iid = self.images.intern(name)
        if iid == len(self.image_sizes):
            self.image_sizes.append(float(size))
        else:
            # keep the max observed size (sizes should agree per name)
            self.image_sizes[iid] = max(self.image_sizes[iid], float(size))
        return iid

    # -- inter-pod affinity / spread ---------------------------------------

    def intern_matcher(
        self, namespaces: Optional[Tuple[str, ...]], selector: LabelSelector
    ) -> int:
        """(namespaces, selector) program matched against pods.
        ``namespaces=None`` = match any namespace (the soft-spread priority
        deliberately skips the namespace check — even_pods_spread.go:137)."""
        key = (tuple(sorted(namespaces)) if namespaces is not None else None,
               _canon_selector(selector))
        mid = self.pod_matchers.intern(key)
        if mid == len(self.pod_matcher_items):
            self.pod_matcher_items.append((namespaces, selector))
        return mid

    def matcher_matches(self, mid: int, pod: Pod) -> bool:
        ns, sel = self.pod_matcher_items[mid]
        if ns is not None and pod.namespace not in ns:
            return False
        return sel.matches(pod.labels)

    def _intern_pod_aff_term(self, pod: Pod, term) -> Tuple[int, int]:
        """(key_id, matcher_id) for one PodAffinityTerm; empty namespaces
        default to the defining pod's namespace (priorities/util
        GetNamespacesFromPodAffinityTerm)."""
        k = self.topo_keys.intern(term.topology_key)
        m = self.intern_matcher(term.namespaces or (pod.namespace,), term.label_selector)
        return k, m

    def intern_affinity_program(self, pod: Pod) -> int:
        """Required pod (anti)affinity of ``pod`` -> program id; also seeds
        the anti-term and sym-term universes with this pod's terms (the
        contributions it will make as an *existing* pod)."""
        a = pod.affinity
        if not (a.pod_affinity_required or a.pod_anti_affinity_required):
            self._seed_sym_terms(pod)
            return -1
        rows: List[Tuple[int, int, bool]] = []
        for t in a.pod_affinity_required:
            k, m = self._intern_pod_aff_term(pod, t)
            rows.append((k, m, False))
        for t in a.pod_anti_affinity_required:
            k, m = self._intern_pod_aff_term(pod, t)
            rows.append((k, m, True))
            self.anti_terms.intern((k, m))
        self._seed_sym_terms(pod)
        key = tuple(rows)
        pid = self.aff_programs.intern(key)
        if pid == len(self.aff_program_rows):
            self.aff_program_rows.append(rows)
        return pid

    def _seed_sym_terms(self, pod: Pod) -> None:
        a = pod.affinity
        for t in a.pod_affinity_required:
            k, m = self._intern_pod_aff_term(pod, t)
            self.sym_terms.intern((k, m, 1.0, SYM_HARD_AFF))
        for wt in a.pod_affinity_preferred:
            k, m = self._intern_pod_aff_term(pod, wt.term)
            self.sym_terms.intern((k, m, float(wt.weight), SYM_SOFT_AFF))
        for wt in a.pod_anti_affinity_preferred:
            k, m = self._intern_pod_aff_term(pod, wt.term)
            self.sym_terms.intern((k, m, float(wt.weight), SYM_SOFT_ANTI))

    def pod_sym_term_ids(self, pod: Pod) -> List[int]:
        """Sym-term ids this pod carries as an existing pod (lookup only)."""
        out = []
        a = pod.affinity
        for t in a.pod_affinity_required:
            k, m = self._intern_pod_aff_term(pod, t)
            out.append(self.sym_terms.lookup((k, m, 1.0, SYM_HARD_AFF)))
        for wt in a.pod_affinity_preferred:
            k, m = self._intern_pod_aff_term(pod, wt.term)
            out.append(self.sym_terms.lookup((k, m, float(wt.weight), SYM_SOFT_AFF)))
        for wt in a.pod_anti_affinity_preferred:
            k, m = self._intern_pod_aff_term(pod, wt.term)
            out.append(self.sym_terms.lookup((k, m, float(wt.weight), SYM_SOFT_ANTI)))
        return [i for i in out if i >= 0]

    def pod_anti_term_ids(self, pod: Pod) -> List[int]:
        out = []
        for t in pod.affinity.pod_anti_affinity_required:
            k, m = self._intern_pod_aff_term(pod, t)
            out.append(self.anti_terms.lookup((k, m)))
        return [i for i in out if i >= 0]

    def intern_pref_affinity_program(self, pod: Pod) -> int:
        """Preferred pod (anti)affinity -> signed weighted rows (the
        incoming-pod half of CalculateInterPodAffinityPriority)."""
        a = pod.affinity
        if not (a.pod_affinity_preferred or a.pod_anti_affinity_preferred):
            return -1
        rows: List[Tuple[int, int, float]] = []
        for wt in a.pod_affinity_preferred:
            k, m = self._intern_pod_aff_term(pod, wt.term)
            rows.append((k, m, float(wt.weight)))
        for wt in a.pod_anti_affinity_preferred:
            k, m = self._intern_pod_aff_term(pod, wt.term)
            rows.append((k, m, -float(wt.weight)))
        key = tuple(rows)
        pid = self.pref_aff_programs.intern(key)
        if pid == len(self.pref_aff_program_rows):
            self.pref_aff_program_rows.append(rows)
        return pid

    def intern_spread_programs(self, pod: Pod, selprog_id: int) -> Tuple[int, int]:
        """(hard_id, soft_id) topology-spread programs. Hard constraints
        match same-namespace pods (metadata.go:246); soft constraints match
        any namespace (even_pods_spread.go:137 — alpha quirk preserved)."""
        hard: List[Tuple[int, int, int]] = []
        soft: List[Tuple[int, int]] = []
        for c in pod.topology_spread:
            k = self.topo_keys.intern(c.topology_key)
            if c.when_unsatisfiable == "DoNotSchedule":
                m = self.intern_matcher((pod.namespace,), c.label_selector)
                hard.append((k, m, int(c.max_skew)))
            else:
                m = self.intern_matcher(None, c.label_selector)
                soft.append((k, m))
        hid = sid = -1
        if hard:
            key = (tuple(hard), selprog_id)
            hid = self.spread_hard_programs.intern(key)
            if hid == len(self.spread_hard_program_rows):
                self.spread_hard_program_rows.append((tuple(hard), selprog_id))
        if soft:
            key = (tuple(soft), selprog_id)
            sid = self.spread_soft_programs.intern(key)
            if sid == len(self.spread_soft_program_rows):
                self.spread_soft_program_rows.append((tuple(soft), selprog_id))
        return hid, sid

    def self_aff_match(self, pod: Pod) -> bool:
        """targetPodMatchesAffinityOfPod(pod, pod): the pod matches the
        namespace+selector of ALL its required affinity terms — the
        first-pod-of-a-group escape hatch (predicates.go:1437)."""
        terms = pod.affinity.pod_affinity_required
        if not terms:
            return False
        for t in terms:
            ns = t.namespaces or (pod.namespace,)
            if pod.namespace not in ns or not t.label_selector.matches(pod.labels):
                return False
        return True

    def pod_matcher_row(self, pod: Pod, width: int) -> np.ndarray:
        """Multihot of matchers this pod satisfies — its contribution to
        per-node matcher counts when it is (or becomes) scheduled.
        Memoized per (registry length, width, ns, labels); callers only
        read the row (+= / assignment into larger arrays copy), so the
        shared array is safe."""
        n = len(self.pod_matcher_items)
        key = (n, width, pod.namespace,
               tuple(sorted(pod.labels.items())))
        row = self._matcher_row_memo.get(key)
        if row is not None:
            return row
        if self._matcher_row_memo and next(
                iter(self._matcher_row_memo))[0] != n:
            # registry grew: every cached row is stale — drop them all
            # (long-lived universes would otherwise accumulate dead keys)
            self._matcher_row_memo.clear()
        row = np.zeros((width,), np.int8)
        for mid in range(n):
            if self.matcher_matches(mid, pod):
                row[mid] = 1
        self._matcher_row_memo[key] = row
        return row

    # -- volumes -----------------------------------------------------------

    def intern_volume_refs(self, rv: ResolvedVolumes) -> None:
        """Seed the volume universes (+ zone label pairs + PV-affinity
        selector programs) with one pod's resolved volumes so widths are
        stable by pack time."""
        for kind, handle, _ro in rv.conflict:
            cid = self.vol_conflict.intern((kind, handle))
            if cid == len(self.vol_conflict_escape):
                self.vol_conflict_escape.append(CONFLICT_RO_ESCAPE[kind])
        for fi, tok in rv.pd:
            self.pd_volumes.intern((fi, tok))
        for driver, handle in rv.csi:
            d = self.csi_drivers.intern(driver)
            self.csi_volumes.intern((d, handle))
        for key, allowed in rv.zone_rows:
            for z in allowed:
                self.label_pairs.intern((key, z))
        for terms in rv.bound_affinity:
            self.intern_node_selector_program({}, Affinity(node_required=tuple(terms)))
        for cands in rv.unbound_clauses:
            for terms in cands:
                if terms:
                    self.intern_node_selector_program(
                        {}, Affinity(node_required=tuple(terms))
                    )

    def pv_affinity_program(self, terms) -> int:
        """Selector-program id of a PV's node affinity (already interned)."""
        return self.intern_node_selector_program({}, Affinity(node_required=tuple(terms)))

    # -- owner selectors (SelectorSpread) ----------------------------------

    def intern_owner_set(self, namespace: str, selectors) -> int:
        if not selectors:
            return -1
        key = (
            namespace,
            tuple(
                (
                    tuple(sorted(s.match_labels.items())),
                    tuple((r.key, r.operator, tuple(r.values)) for r in s.match_expressions),
                )
                for s in selectors
            ),
        )
        oid = self.owner_sets.intern(key)
        if oid == len(self.owner_set_items):
            self.owner_set_items.append((namespace, tuple(selectors)))
        return oid


# ---------------------------------------------------------------------------
# Packed tables (host-side numpy; converted to device arrays at the jit
# boundary — see kubernetes_tpu_torch.ops)
# ---------------------------------------------------------------------------


@dataclass
class NodeTable:
    """Columnar NodeInfo over all nodes. Row order is the packing order;
    ``name_id[i]`` maps back to the node name."""

    n: int
    name_id: np.ndarray  # (N,) i32
    allocatable: np.ndarray  # (N, R) f32
    requested: np.ndarray  # (N, R) f32 — sum of scheduled pods' requests
    nonzero_req: np.ndarray  # (N, 2) f32 — scoring request sums w/ defaults
    pair_mh: np.ndarray  # (N, Up) i8 — has (key,value) for interned pairs
    key_mh: np.ndarray  # (N, Uk) i8 — has key
    key_val: np.ndarray  # (N, Uk) f32 — numeric label value (0 if not)
    key_num: np.ndarray  # (N, Uk) i8 — label value parsed as integer OK
    taint_hard_mh: np.ndarray  # (N, Ut) i8 — NoSchedule|NoExecute taints
    taint_soft_mh: np.ndarray  # (N, Ut) i8 — PreferNoSchedule taints
    port_any_mh: np.ndarray  # (N, Upp) i8 — (proto,port) used by any pod
    port_wild_mh: np.ndarray  # (N, Upp) i8 — used with wildcard hostIP
    port_spec_mh: np.ndarray  # (N, Upip) i8 — used with specific hostIP
    image_mh: np.ndarray  # (N, Ui) i8
    owner_counts: np.ndarray  # (N, Uo) f32 — matching scheduled pods per owner set
    zone_id: np.ndarray  # (N,) i32 — interned (region, zone); -1 unlabeled
    zone_valid: np.ndarray  # (Z,) bool — static zone-universe size carrier
    avoid_mh: np.ndarray  # (N, Uu) i8 — preferAvoidPods owner UIDs
    ready: np.ndarray  # (N,) bool
    network_unavailable: np.ndarray  # (N,) bool
    schedulable: np.ndarray  # (N,) bool — NOT spec.unschedulable
    mem_pressure: np.ndarray  # (N,) bool
    disk_pressure: np.ndarray  # (N,) bool
    pid_pressure: np.ndarray  # (N,) bool
    # ---- inter-pod affinity / spread state -------------------------------
    topo_pair_id: np.ndarray  # (N, K) i32 — node's pair per topo key; -1 absent
    matcher_counts: np.ndarray  # (N, M) f32 — scheduled pods matching matcher m
    anti_counts: np.ndarray  # (N, Ua) f32 — pods carrying required anti term a
    sym_counts: np.ndarray  # (N, Us) f32 — pods carrying sym scoring term s
    aff_pod_count: np.ndarray  # (N,) f32 — pods with any (anti)affinity
    # ---- volume state ----------------------------------------------------
    vol_any_mh: np.ndarray  # (N, Uv) i8 — conflict token mounted by any pod
    vol_rw_mh: np.ndarray  # (N, Uv) i8 — mounted NOT read-only by some pod
    pd_mh: np.ndarray  # (N, Uvd) i8 — count-checked volume tokens present
    pd_limit: np.ndarray  # (N, 4) f32 — attach limit per in-tree filter kind
    csi_mh: np.ndarray  # (N, Uvc) i8 — CSI volume tokens present
    csi_limit: np.ndarray  # (N, Dc) f32 — per-driver limit; +inf = none
    has_zone_label: np.ndarray  # (N,) bool — VolumeZone fast-path carrier


@dataclass
class PodTable:
    """Columnar pending-pod batch."""

    n: int
    req: np.ndarray  # (P, R) f32
    nonzero_req: np.ndarray  # (P, 2) f32
    selprog_id: np.ndarray  # (P,) i32, -1 = unconstrained
    prefprog_id: np.ndarray  # (P,) i32, -1 = none
    tolset_id: np.ndarray  # (P,) i32, -1 = no tolerations
    name_req: np.ndarray  # (P,) i32, -1 = no spec.nodeName requirement
    priority: np.ndarray  # (P,) i32
    port_wild_pp: np.ndarray  # (P, Upp) i8 — wildcard-IP ports
    port_spec_pp: np.ndarray  # (P, Upp) i8 — specific-IP ports, (proto,port) view
    port_spec_pip: np.ndarray  # (P, Upip) i8
    image_mh: np.ndarray  # (P, Ui) i8
    owner_id: np.ndarray  # (P,) i32, -1 = no owning service/controller
    owner_uid_id: np.ndarray  # (P,) i32, -1 = no controller ownerRef
    #: which owner sets this pod's labels match — placing the pod bumps
    #: those columns of NodeTable.owner_counts (device-side spread update)
    owner_match_mh: np.ndarray  # (P, Uo) i8
    order: np.ndarray  # (P,) i32 — original index of each row (sort tracking)
    # ---- inter-pod affinity / spread -------------------------------------
    matcher_mh: np.ndarray  # (P, M) i8 — matchers this pod satisfies
    affprog_id: np.ndarray  # (P,) i32 — required (anti)affinity program; -1 none
    prefaffprog_id: np.ndarray  # (P,) i32 — preferred program; -1 none
    spread_hard_id: np.ndarray  # (P,) i32
    spread_soft_id: np.ndarray  # (P,) i32
    self_aff_match: np.ndarray  # (P,) bool — pod matches own affinity terms
    anti_term_mh: np.ndarray  # (P, Ua) i8 — its required anti terms
    sym_term_mh: np.ndarray  # (P, Us) f32 — its sym terms (counts, can repeat)
    has_aff: np.ndarray  # (P,) bool — any pod (anti)affinity at all
    # ---- volumes ---------------------------------------------------------
    vol_any_mh: np.ndarray  # (P, Uv) i8
    vol_rw_mh: np.ndarray  # (P, Uv) i8
    pd_mh: np.ndarray  # (P, Uvd) i8
    csi_mh: np.ndarray  # (P, Uvc) i8
    vol_error: np.ndarray  # (P,) bool — unresolvable volume state
    #: (P, 2) f32 cpu/mem LIMITS (ResourceLimitsPriority)
    limits: np.ndarray = None


@dataclass
class SelectorTables:
    """Flattened expression tables for required + preferred programs, plus
    per-toleration-set tolerated-taint multihots."""

    # required programs
    n_exprs: int
    n_terms: int
    n_progs: int
    expr_term: np.ndarray  # (E,) i32 — term id of each expr
    expr_op: np.ndarray  # (E,) i32
    expr_pairs_mh: np.ndarray  # (E, Up) i8
    expr_key: np.ndarray  # (E,) i32 (index into key universe; -1 unused)
    expr_lit: np.ndarray  # (E,) f32
    term_prog: np.ndarray  # (T,) i32 — program id of each term
    # preferred programs (flat weighted terms)
    p_n_exprs: int
    p_n_terms: int
    p_n_progs: int
    p_expr_term: np.ndarray
    p_expr_op: np.ndarray
    p_expr_pairs_mh: np.ndarray
    p_expr_key: np.ndarray
    p_expr_lit: np.ndarray
    p_term_prog: np.ndarray
    p_term_weight: np.ndarray  # (Tp,) f32
    # tolerations
    tol_hard_mh: np.ndarray  # (Stol, Ut) i8 — taint ids tolerated (hard effects)
    tol_soft_mh: np.ndarray  # (Stol, Ut) i8 — PreferNoSchedule taint ids tolerated
    image_sizes: np.ndarray  # (Ui,) f32


@dataclass
class TopologyTables:
    """Flattened inter-pod-affinity + topology-spread term tables — the
    static (per-universe) half of the topologyPairsMaps machinery
    (predicates/metadata.go:65); the dynamic half is the per-node count
    matrices in NodeTable (matcher/anti/sym counts) that the assignment
    loop updates as pods land."""

    n_pairs: int  # true topo-pair count (arrays padded to bucket)
    n_matchers: int  # matcher-universe width M (bucketed, = widths()["M"])
    # required (anti)affinity rows
    ra_n_rows: int
    ra_n_progs: int
    ra_prog: np.ndarray  # (Ta,) i32
    ra_key: np.ndarray  # (Ta,) i32 — topo-key index
    ra_m: np.ndarray  # (Ta,) i32 — matcher id
    ra_anti: np.ndarray  # (Ta,) bool
    # preferred rows (signed weights)
    rp_n_rows: int
    rp_n_progs: int
    rp_prog: np.ndarray
    rp_key: np.ndarray
    rp_m: np.ndarray
    rp_w: np.ndarray  # (Tp,) f32 signed
    # anti-term table (columns of NodeTable.anti_counts)
    at_key: np.ndarray  # (Ua,) i32
    at_m: np.ndarray  # (Ua,) i32
    # sym-term table (columns of NodeTable.sym_counts)
    st_key: np.ndarray  # (Us,) i32
    st_m: np.ndarray  # (Us,) i32
    st_w: np.ndarray  # (Us,) f32 — signed soft weight; 0 for hard terms
    st_hard: np.ndarray  # (Us,) f32 — 1 for hard-affinity terms
    # spread hard rows + per-program candidacy selector
    sh_n_rows: int
    sh_n_progs: int
    sh_prog: np.ndarray
    sh_key: np.ndarray
    sh_m: np.ndarray
    sh_skew: np.ndarray  # (Tsh,) f32
    shp_selprog: np.ndarray  # (Gsh,) i32 — node-selector program; -1 = all
    # spread soft rows
    ss_n_rows: int
    ss_n_progs: int
    ss_prog: np.ndarray
    ss_key: np.ndarray
    ss_m: np.ndarray
    ssp_selprog: np.ndarray  # (Gss,) i32


@dataclass
class VolumeTables:
    """Universe-level volume metadata + batch-level zone/binding constraint
    rows for one pending-pod pack (row indices reference that batch)."""

    conflict_escape: np.ndarray  # (Uv,) f32 — read-only escape per token
    pd_type: np.ndarray  # (Uvd,) i32 — filter kind of each count token
    csi_driver: np.ndarray  # (Uvc,) i32 — driver id of each CSI token
    n_csi_drivers: int
    # VolumeZone rows: AND across a pod's rows; a row passes on nodes that
    # carry one of the allowed (key, value) label pairs or no zone labels
    vz_n_rows: int
    vz_pod: np.ndarray  # (Rv,) i32
    vz_pairs_mh: np.ndarray  # (Rv, Up) i8
    # VolumeBinding CNF: AND over clauses; clause = OR over rows, each row
    # one PV-affinity selector program; empty clause = unsatisfiable
    vb_n_rows: int
    vb_n_clauses: int
    vb_row_clause: np.ndarray  # (Rb,) i32
    vb_row_prog: np.ndarray  # (Rb,) i32
    vb_clause_pod: np.ndarray  # (Cb,) i32
    vb_clause_bound: np.ndarray  # (Cb,) bool — bound- vs unbound-PVC clause


def _aggregate_usage(pod_req: np.ndarray, pod_nz: np.ndarray,
                     pod_row: np.ndarray, out_req: np.ndarray,
                     out_nz: np.ndarray) -> None:
    """In-place scatter-add of pod requests into node usage arrays (the
    NodeInfo.AddPod accumulation), sequential in pod order. Rows < 0
    skip."""
    ok = pod_row >= 0
    np.add.at(out_req, pod_row[ok], np.asarray(pod_req, np.float32)[ok])
    np.add.at(out_nz, pod_row[ok], np.asarray(pod_nz, np.float32)[ok])


def _pod_has_affinity(pod: Pod) -> bool:
    """NodeInfo.PodsWithAffinity membership: any pod (anti)affinity,
    required or preferred (nodeinfo/node_info.go AddPod)."""
    a = pod.affinity
    return bool(
        a.pod_affinity_required
        or a.pod_anti_affinity_required
        or a.pod_affinity_preferred
        or a.pod_anti_affinity_preferred
    )


def _matching_owner_sets(u: Universe, pod: Pod) -> List[int]:
    """Owner-set ids whose (namespace, selectors) match this pod — the
    single source of truth for SelectorSpread matching, used for both
    NodeTable.owner_counts and PodTable.owner_match_mh (which the
    assignment usage updates assume are computed identically).
    Memoized per (registry length, ns, labels) — see Universe's
    fingerprint memos."""
    n = len(u.owner_set_items)
    key = (n, pod.namespace, tuple(sorted(pod.labels.items())))
    hit = u._owner_sets_memo.get(key)
    if hit is not None:
        return hit
    if u._owner_sets_memo and next(iter(u._owner_sets_memo))[0] != n:
        u._owner_sets_memo.clear()  # registry grew: all entries stale
    out = [
        o
        for o, (ns, sels) in enumerate(u.owner_set_items)
        if ns == pod.namespace and all(s.matches(pod.labels) for s in sels)
    ]
    u._owner_sets_memo[key] = out
    return out


class SnapshotPacker:
    """Packs API objects into the columnar tables. The driver calls
    ``intern_pod`` on arrival (so universes are stable by pack time), then
    ``pack_nodes`` / ``pack_pods`` per scheduling cycle.

    Column widths are padded to power-of-two buckets (``bucket_size``) so
    that XLA shapes stay stable while universes grow.
    """

    def __init__(self, universe: Optional[Universe] = None) -> None:
        self.u = universe or Universe()
        self._pod_refs: Dict[tuple, Tuple[int, int, int, int]] = {}
        #: monotonically bumped whenever state OUTSIDE the append-only
        #: universes can change already-packed row content: volume-state
        #: replacement, assume/bind claim-lifecycle invalidation, pod
        #: forgetting. Part of every pack-memo key (universe_sig), so a
        #: memoized table can never outlive the state it was packed from.
        self._pack_epoch = 0
        #: memoized PodTable / VolumeTables per (batch identity, universe
        #: signature): steady-state cycles re-pack the SAME pending pods
        #: (backoff retries, bench warm loops) — a hit turns the per-pod
        #: python packing loop into one tuple hash. Bounded LRU.
        self._pod_table_memo: "OrderedDict[tuple, PodTable]" = OrderedDict()
        self._vol_table_memo: "OrderedDict[tuple, VolumeTables]" = OrderedDict()
        # volume listers + per-pod resolution cache (state-dependent, so
        # cached separately from _pod_refs and dropped on state change)
        self.vol_state = VolumeState()
        self._vol_pods: Dict[tuple, Pod] = {}
        self._vol_cache: Dict[tuple, ResolvedVolumes] = {}
        # per-pod resource vectors (R-dependent; recomputed when the scalar
        # universe grows) feeding the usage aggregation
        self._vec_cache: Dict[tuple, Tuple[int, np.ndarray, np.ndarray]] = {}
        #: node name -> PV names attached there WITHOUT a live bound pod
        #: using them (the attach-detach controller's actual-state
        #: residue: detach-grace stragglers). These occupy attach-limit
        #: slots, so the volume-count predicates must see them even
        #: though no pod's volumes derive them (attach_detach_controller
        #: .go:102 — actual state feeds the scheduler via node.status
        #: volumesAttached in the reference).
        self.attached_residue: Dict[str, Tuple[str, ...]] = {}

    # -- volume state ------------------------------------------------------

    def set_volume_state(self, pvcs=(), pvs=(), classes=()) -> None:
        """Replace the PVC/PV/StorageClass listers (informer feed analog).
        All known pods' volumes re-resolve so universes stay complete.
        The ASSUME overlay carries over: reservations are binder state,
        not lister data — an informer relist never clears the reference's
        pvCache assumptions (assume wins until bind or forget), and a
        hub-driven re-sync mid-Permit must not leak another claimant onto
        a reserved PV."""
        assumed = dict(self.vol_state.assumed_claims)
        self.vol_state = VolumeState.build(pvcs, pvs, classes)
        self.vol_state.assumed_claims.update(assumed)
        self._vol_cache.clear()
        self._pack_epoch += 1
        for pod in self._vol_pods.values():
            self.resolve_volumes(pod)

    def refresh_volume_resolutions(self) -> None:
        """Invalidate memoized volume resolutions — the assume/bind
        lifecycle mutates claim state in place (assumed_claims overlay,
        committed claimRefs), which changes unbound-clause candidate sets
        for other claimants. Lazy: re-resolution happens on the next
        resolve_volumes call per pod (the pack paths all go through it),
        so N lifecycle transitions in one cycle cost one re-resolution
        sweep at the next pack, not N eager sweeps."""
        self._vol_cache.clear()
        self._pack_epoch += 1

    def resolve_volumes(self, pod: Pod) -> ResolvedVolumes:
        key = (pod.key(), pod.uid)
        rv = self._vol_cache.get(key)
        if rv is None:
            rv = resolve_pod_volumes(pod, self.vol_state)
            self.u.intern_volume_refs(rv)
            self._vol_cache[key] = rv
        return rv

    def forget_pod(self, pod_key: str) -> None:
        """Drop per-pod memoization for a deleted pod so churn doesn't grow
        the caches (and set_volume_state doesn't re-resolve dead pods)
        forever. Universe tokens stay — interners are append-only by design
        (bucketed widths make stale entries cheap)."""
        for cache in (self._pod_refs, self._vol_cache, self._vol_pods,
                      self._vec_cache):
            for k in [k for k in cache if k[0] == pod_key]:
                del cache[k]
        self._pack_epoch += 1

    def _pod_vectors(self, pods: Sequence[Pod], R: int):
        """(P, R) request matrix + (P, 2) nonzero matrix, cached per pod
        (invalidated when the resource universe width changes)."""
        req = np.zeros((len(pods), R), np.float32)
        nz = np.zeros((len(pods), 2), np.float32)
        for idx, p in enumerate(pods):
            ck = (p.key(), p.uid)
            ent = self._vec_cache.get(ck)
            if ent is None or ent[0] != R:
                ent = (
                    R,
                    self.u.resource_vector(p.effective_requests(), R),
                    np.asarray(p.nonzero_requests(), np.float32),
                )
                self._vec_cache[ck] = ent
            req[idx] = ent[1]
            nz[idx] = ent[2]
        return req, nz

    # -- interning ---------------------------------------------------------

    def intern_pod(self, pod: Pod) -> Tuple[int, ...]:
        """Returns (selprog, prefprog, tolset, owner, affprog, prefaffprog,
        spread_hard, spread_soft) ids, cached per pod identity
        (namespace/name/uid — uid so a deleted-and-recreated pod with
        different spec is re-interned)."""
        if pod.volumes:
            self._vol_pods[(pod.key(), pod.uid)] = pod
            self.resolve_volumes(pod)
        cached = self._pod_refs.get((pod.key(), pod.uid))
        if cached is not None:
            return cached
        u = self.u
        selprog = u.intern_node_selector_program(pod.node_selector, pod.affinity)
        spread_hard, spread_soft = u.intern_spread_programs(pod, selprog)
        refs = (
            selprog,
            u.intern_preferred_program(pod.affinity),
            u.intern_toleration_set(pod.tolerations),
            u.intern_owner_set(pod.namespace, pod.spread_selectors),
            u.intern_affinity_program(pod),
            u.intern_pref_affinity_program(pod),
            spread_hard,
            spread_soft,
        )
        for name in pod.requests.scalars:
            u.scalar_resources.intern(name)
        for proto, ip, port in pod.host_ports:
            u.ports_pp.intern((proto, port))
            if ip and ip != "0.0.0.0":
                u.ports_pip.intern((proto, ip, port))
        for img in pod.images:
            iid = u.images.intern(img)
            if iid == len(u.image_sizes):
                u.image_sizes.append(0.0)
        if pod.owner_uid:
            u.owner_uids.intern(pod.owner_uid)
        self._pod_refs[(pod.key(), pod.uid)] = refs
        return refs

    def intern_node(self, node: Node) -> int:
        u = self.u
        nid = u.node_names.intern(node.name)
        for t in node.taints:
            u.intern_taint(t.key, t.value, t.effect)
        for img, size in node.images.items():
            u.intern_image(img, size)
        for name in node.allocatable.scalars:
            u.scalar_resources.intern(name)
        return nid

    def _intern_node_topo_pairs(self, node: Node) -> None:
        """Intern this node's (topo key, value) pairs for every topo key the
        universe knows; must run after all pods of the cycle are interned so
        the key set is complete."""
        u = self.u
        for kid, key in enumerate(u.topo_keys.items()):
            v = node.labels.get(key)
            if v is not None:
                u.topo_pairs.intern((kid, v))

    # -- universe signature / pack memo ------------------------------------

    #: memoized tables kept per packer (steady state needs exactly the
    #: in-flight batch plus the retried one; more is waste)
    PACK_MEMO_CAPACITY = 8

    def universe_sig(self) -> Tuple:
        """Cheap exact fingerprint of everything that can change packed
        row CONTENT for a fixed pod set: every interner's length (the
        interners are append-only, so equal length means equal content),
        the resource-universe width, and the pack epoch (volume-state /
        claim-lifecycle / forget invalidations). Two packs of the same
        pods under equal signatures are bit-identical."""
        return (*self.universe_node_sig(), self._pack_epoch)

    def universe_node_sig(self) -> Tuple:
        """Node-row content signature: every interner's length + the
        resource width. ANY universe growth can change already-packed
        node rows even when the power-of-two widths() don't move — a
        pending pod interning a new (key, value) selector pair must
        flip pair_mh on every clean node carrying that label (the
        sub-bucket staleness the delta property test caught). Unlike
        :meth:`universe_sig` this excludes the pack epoch: forget_pod
        and claim-lifecycle invalidations never change node rows
        (volume-STATE replacement does, and set_volume_state callers
        invalidate the snapshot explicitly — scheduler.set_volume_state)."""
        u = self.u
        lens = tuple(
            len(v) for _, v in sorted(vars(u).items())
            if isinstance(v, Interner)
        )
        return (lens, len(u.image_sizes), u.n_resources())

    @staticmethod
    def _memo_get(memo: "OrderedDict", key):
        hit = memo.get(key)
        if hit is not None:
            memo.move_to_end(key)
        return hit

    def _memo_put(self, memo: "OrderedDict", key, value):
        memo[key] = value
        if len(memo) > self.PACK_MEMO_CAPACITY:
            memo.popitem(last=False)

    # -- widths ------------------------------------------------------------

    def widths(self) -> Dict[str, int]:
        u = self.u
        return {
            "R": u.n_resources(),
            "Up": bucket_size(len(u.label_pairs)),
            "Uk": bucket_size(len(u.label_keys)),
            "Ut": bucket_size(len(u.taints)),
            "Upp": bucket_size(len(u.ports_pp)),
            "Upip": bucket_size(len(u.ports_pip)),
            "Ui": bucket_size(len(u.images)),
            "Uo": bucket_size(len(u.owner_sets)),
            "Uu": bucket_size(len(u.owner_uids)),
            "K": bucket_size(len(u.topo_keys), 2),
            "Utp": bucket_size(len(u.topo_pairs)),
            "M": bucket_size(len(u.pod_matchers)),
            "Ua": bucket_size(len(u.anti_terms), 4),
            "Us": bucket_size(len(u.sym_terms), 4),
            "Uv": bucket_size(len(u.vol_conflict), 4),
            "Uvd": bucket_size(len(u.pd_volumes), 4),
            "Uvc": bucket_size(len(u.csi_volumes), 4),
            "Dc": bucket_size(len(u.csi_drivers), 4),
        }

    # -- nodes -------------------------------------------------------------

    def pack_nodes(
        self,
        nodes: Sequence[Node],
        scheduled_pods: Sequence[Pod] = (),
    ) -> NodeTable:
        u = self.u
        for nd in nodes:
            self.intern_node(nd)
        for p in scheduled_pods:
            self.intern_pod(p)
        for nd in nodes:
            self._intern_node_topo_pairs(nd)
        if self.attached_residue:
            # residue tokens must exist in the universes BEFORE widths()
            # sizes the arrays (lookup returns -1 for unknown tokens)
            from kubernetes_tpu_torch.volumes import attachable_tokens

            for pv_names in self.attached_residue.values():
                for pv_name in pv_names:
                    pv = self.vol_state.pv(pv_name)
                    if pv is None:
                        continue
                    for kind, a, b in attachable_tokens(pv):
                        if kind == "pd":
                            u.pd_volumes.intern((a, b))
                        else:
                            u.csi_volumes.intern(
                                (u.csi_drivers.intern(a), b))
        w = self.widths()
        n = len(nodes)
        R = w["R"]
        name_id = np.full((n,), -1, np.int32)
        allocatable = np.zeros((n, R), np.float32)
        requested = np.zeros((n, R), np.float32)
        nonzero_req = np.zeros((n, 2), np.float32)
        pair_mh = np.zeros((n, w["Up"]), np.int8)
        key_mh = np.zeros((n, w["Uk"]), np.int8)
        key_val = np.zeros((n, w["Uk"]), np.float32)
        key_num = np.zeros((n, w["Uk"]), np.int8)
        taint_hard = np.zeros((n, w["Ut"]), np.int8)
        taint_soft = np.zeros((n, w["Ut"]), np.int8)
        port_any = np.zeros((n, w["Upp"]), np.int8)
        port_wild = np.zeros((n, w["Upp"]), np.int8)
        port_spec = np.zeros((n, w["Upip"]), np.int8)
        image_mh = np.zeros((n, w["Ui"]), np.int8)
        owner_counts = np.zeros((n, w["Uo"]), np.float32)
        zone_id = np.full((n,), -1, np.int32)
        avoid_mh = np.zeros((n, w["Uu"]), np.int8)
        ready = np.zeros((n,), bool)
        net_unavail = np.zeros((n,), bool)
        schedulable = np.zeros((n,), bool)
        mem_p = np.zeros((n,), bool)
        disk_p = np.zeros((n,), bool)
        pid_p = np.zeros((n,), bool)
        topo_pair_id = np.full((n, w["K"]), -1, np.int32)
        matcher_counts = np.zeros((n, w["M"]), np.float32)
        anti_counts = np.zeros((n, w["Ua"]), np.float32)
        sym_counts = np.zeros((n, w["Us"]), np.float32)
        aff_pod_count = np.zeros((n,), np.float32)
        vol_any = np.zeros((n, w["Uv"]), np.int8)
        vol_rw = np.zeros((n, w["Uv"]), np.int8)
        pd_mh = np.zeros((n, w["Uvd"]), np.int8)
        pd_limit = np.zeros((n, N_PD_FILTERS), np.float32)
        csi_mh = np.zeros((n, w["Uvc"]), np.int8)
        csi_limit = np.full((n, w["Dc"]), np.inf, np.float32)
        has_zone = np.zeros((n,), bool)
        driver_names = u.csi_drivers.items()

        row_of: Dict[int, int] = {}
        for i, nd in enumerate(nodes):
            nid = u.node_names.intern(nd.name)
            row_of[nid] = i
            name_id[i] = nid
            allocatable[i] = self.u.resource_vector(nd.allocatable, R)
            for k, v in nd.labels.items():
                pi = u.label_pairs.lookup((k, v))
                if pi >= 0:
                    pair_mh[i, pi] = 1
                ki = u.label_keys.lookup(k)
                if ki >= 0:
                    key_mh[i, ki] = 1
                    # strict integer syntax like Go strconv.ParseInt —
                    # Python int() would accept "1_0"/" 10 "/unicode digits
                    if _GO_INT_RE.match(v):
                        key_val[i, ki] = float(int(v))
                        key_num[i, ki] = 1
            for t in nd.taints:
                ti = u.intern_taint(t.key, t.value, t.effect)
                if t.effect in (EFFECT_NO_SCHEDULE, EFFECT_NO_EXECUTE):
                    taint_hard[i, ti] = 1
                elif t.effect == EFFECT_PREFER_NO_SCHEDULE:
                    taint_soft[i, ti] = 1
            for img, size in nd.images.items():
                image_mh[i, u.intern_image(img, size)] = 1
            zk = nd.zone_key()
            if zk is not None:
                zone_id[i] = u.zones.intern(zk)
            for uid in nd.prefer_avoid_owner_uids:
                ui = u.owner_uids.lookup(uid)
                if ui >= 0:
                    avoid_mh[i, ui] = 1
            ready[i] = nd.conditions.ready
            net_unavail[i] = nd.conditions.network_unavailable
            schedulable[i] = not nd.unschedulable
            mem_p[i] = nd.conditions.memory_pressure
            disk_p[i] = nd.conditions.disk_pressure
            pid_p[i] = nd.conditions.pid_pressure
            for kid, key in enumerate(u.topo_keys.items()):
                v = nd.labels.get(key)
                if v is not None:
                    topo_pair_id[i, kid] = u.topo_pairs.lookup((kid, v))
            pd_limit[i] = node_pd_limits(nd)
            has_zone[i] = node_has_zone_label(nd)
            for d, driver in enumerate(driver_names):
                lim = nd.allocatable.scalars.get(CSI_LIMIT_PREFIX + driver)
                if lim is not None:
                    csi_limit[i, d] = lim

        # aggregate scheduled pods into node usage (NodeInfo.AddPod,
        # node_info.go — requested, nonzeroRequest, usedPorts, pod count).
        # The resource columns — every pod contributes, dominating full
        # repacks at scale — one sequential f32 scatter-add in pod order
        # (np.add.at, the same accumulation order as the reference
        # package's native kernel) with cached per-pod vectors; the
        # sparse attributes (ports/owners/matchers/affinity/volumes)
        # stay in Python, gated so pods without them cost nothing.
        pod_rows = np.fromiter(
            (
                row_of.get(u.node_names.lookup(p.node_name), -1)
                for p in scheduled_pods
            ),
            np.int32,
            count=len(scheduled_pods),
        )
        req_mat, nz_mat = self._pod_vectors(scheduled_pods, R)
        _aggregate_usage(req_mat, nz_mat, pod_rows, requested, nonzero_req)

        has_matchers = bool(u.pod_matcher_items)
        has_owners = bool(u.owner_set_items)
        for p, i in zip(scheduled_pods, pod_rows):
            if i < 0:
                continue
            for proto, ip, port in p.host_ports:
                ppi = u.ports_pp.intern((proto, port))
                port_any[i, ppi] = 1
                if not ip or ip == "0.0.0.0":
                    port_wild[i, ppi] = 1
                else:
                    port_spec[i, u.ports_pip.intern((proto, ip, port))] = 1
            # owner_counts: for SelectorSpread we need, per owner-set, how
            # many *matching* scheduled pods sit on each node. A scheduled
            # pod contributes to owner set `o` if it matches o's selectors.
            if has_owners:
                for o in _matching_owner_sets(u, p):
                    owner_counts[i, o] += 1
            # inter-pod affinity / spread count matrices
            if has_matchers:
                matcher_counts[i] += self.u.pod_matcher_row(p, w["M"])
            if _pod_has_affinity(p):
                for a in u.pod_anti_term_ids(p):
                    anti_counts[i, a] += 1
                for s in u.pod_sym_term_ids(p):
                    sym_counts[i, s] += 1
                aff_pod_count[i] += 1
            if p.volumes:
                rv = self.resolve_volumes(p)
                for kind, handle, ro in rv.conflict:
                    cid = u.vol_conflict.lookup((kind, handle))
                    vol_any[i, cid] = 1
                    if not ro:
                        vol_rw[i, cid] = 1
                for fi, tok in rv.pd:
                    pd_mh[i, u.pd_volumes.lookup((fi, tok))] = 1
                for driver, handle in rv.csi:
                    d = u.csi_drivers.lookup(driver)
                    csi_mh[i, u.csi_volumes.lookup((d, handle))] = 1

        # attach-controller residue: volumes still attached (detach
        # grace) with no live pod deriving them — they hold real
        # attach-limit slots on the node until the controller detaches
        if self.attached_residue:
            from kubernetes_tpu_torch.volumes import attachable_tokens

            for i, node in enumerate(nodes):
                for pv_name in self.attached_residue.get(node.name, ()):
                    pv = self.vol_state.pv(pv_name)
                    if pv is None:
                        continue  # PV deleted mid-grace: slot freed
                    for kind, a, b in attachable_tokens(pv):
                        if kind == "pd":
                            pd_mh[i, u.pd_volumes.lookup((a, b))] = 1
                        else:
                            d = u.csi_drivers.lookup(a)
                            csi_mh[i, u.csi_volumes.lookup((d, b))] = 1

        return NodeTable(
            n=n,
            name_id=name_id,
            allocatable=allocatable,
            requested=requested,
            nonzero_req=nonzero_req,
            pair_mh=pair_mh,
            key_mh=key_mh,
            key_val=key_val,
            key_num=key_num,
            taint_hard_mh=taint_hard,
            taint_soft_mh=taint_soft,
            port_any_mh=port_any,
            port_wild_mh=port_wild,
            port_spec_mh=port_spec,
            image_mh=image_mh,
            owner_counts=owner_counts,
            zone_id=zone_id,
            zone_valid=(
                np.arange(bucket_size(max(len(u.zones), 1))) < len(u.zones)
            ),
            avoid_mh=avoid_mh,
            ready=ready,
            network_unavailable=net_unavail,
            schedulable=schedulable,
            mem_pressure=mem_p,
            disk_pressure=disk_p,
            pid_pressure=pid_p,
            topo_pair_id=topo_pair_id,
            matcher_counts=matcher_counts,
            anti_counts=anti_counts,
            sym_counts=sym_counts,
            aff_pod_count=aff_pod_count,
            vol_any_mh=vol_any,
            vol_rw_mh=vol_rw,
            pd_mh=pd_mh,
            pd_limit=pd_limit,
            csi_mh=csi_mh,
            csi_limit=csi_limit,
            has_zone_label=has_zone,
        )

    # -- node deltas -------------------------------------------------------

    def pack_nodes_delta(
        self,
        nodes: Sequence[Node],
        scheduled_pods: Sequence[Pod] = (),
    ) -> NodeTable:
        """Re-pack ONLY the given (dirty) nodes with their scheduled pods.

        pack_nodes row computation is node-local — every cross-node input
        lives in the shared append-only universe — so a subset pack yields
        rows bit-identical to the same rows of a full pack (the delta-vs-
        full property test pins this). The caller (SchedulerCache) owns
        the row mapping and scatters the result into its resident host
        and device tables; a width change during the delta pack makes the
        delta unusable and the caller must fall back to a full rebuild
        (it compares ``widths()`` before/after)."""
        return self.pack_nodes(nodes, scheduled_pods)

    # -- pods --------------------------------------------------------------

    def pack_pods(self, pods: Sequence[Pod]) -> PodTable:
        """Columnar pending-pod batch, memoized per (batch identity,
        universe signature): the steady-state driver re-packs the same
        backoff-retried pods and the bench re-packs its warmed chunk —
        under an unchanged signature the previous table is bit-identical
        by construction, so the per-pod packing loop collapses to one
        tuple hash. Any universe growth or pack-epoch bump (volume state,
        claim lifecycle, forget_pod) changes the signature and misses."""
        for p in pods:
            self.intern_pod(p)
        ids = tuple((p.key(), p.uid) for p in pods)
        key = (ids, self.universe_sig())
        hit = self._memo_get(self._pod_table_memo, key)
        if hit is not None:
            return hit
        table = self._pack_pods_uncached(pods)
        # packing the rows may itself have interned (ports seen first at
        # pack time) — store under the POST-pack signature so the next
        # identical call (whose intern loop is then a no-op) hits
        self._memo_put(self._pod_table_memo, (ids, self.universe_sig()),
                       table)
        return table

    def _pack_pods_uncached(self, pods: Sequence[Pod]) -> PodTable:
        # pods are already interned — pack_pods (the only caller) runs
        # the intern loop before computing the memo key
        u = self.u
        w = self.widths()
        n = len(pods)
        R = w["R"]
        req = np.zeros((n, R), np.float32)
        nonzero = np.zeros((n, 2), np.float32)
        selprog = np.full((n,), -1, np.int32)
        prefprog = np.full((n,), -1, np.int32)
        tolset = np.full((n,), -1, np.int32)
        name_req = np.full((n,), -1, np.int32)
        priority = np.zeros((n,), np.int32)
        port_wild_pp = np.zeros((n, w["Upp"]), np.int8)
        port_spec_pp = np.zeros((n, w["Upp"]), np.int8)
        port_spec_pip = np.zeros((n, w["Upip"]), np.int8)
        image_mh = np.zeros((n, w["Ui"]), np.int8)
        owner = np.full((n,), -1, np.int32)
        owner_uid = np.full((n,), -1, np.int32)
        owner_match = np.zeros((n, w["Uo"]), np.int8)
        matcher_mh = np.zeros((n, w["M"]), np.int8)
        affprog = np.full((n,), -1, np.int32)
        prefaffprog = np.full((n,), -1, np.int32)
        spread_hard = np.full((n,), -1, np.int32)
        spread_soft = np.full((n,), -1, np.int32)
        self_aff = np.zeros((n,), bool)
        anti_term_mh = np.zeros((n, w["Ua"]), np.float32)
        sym_term_mh = np.zeros((n, w["Us"]), np.float32)
        has_aff = np.zeros((n,), bool)
        vol_any = np.zeros((n, w["Uv"]), np.int8)
        vol_rw = np.zeros((n, w["Uv"]), np.int8)
        pd_mh = np.zeros((n, w["Uvd"]), np.int8)
        csi_mh = np.zeros((n, w["Uvc"]), np.int8)
        vol_error = np.zeros((n,), bool)
        limits = np.zeros((n, 2), np.float32)

        for i, p in enumerate(pods):
            refs = self.intern_pod(p)
            (selprog[i], prefprog[i], tolset[i], owner[i],
             affprog[i], prefaffprog[i], spread_hard[i], spread_soft[i]) = refs
            matcher_mh[i] = u.pod_matcher_row(p, w["M"])
            for a in u.pod_anti_term_ids(p):
                anti_term_mh[i, a] += 1
            for s in u.pod_sym_term_ids(p):
                sym_term_mh[i, s] += 1
            self_aff[i] = u.self_aff_match(p)
            has_aff[i] = _pod_has_affinity(p)
            req[i] = self.u.resource_vector(p.effective_requests(), R)
            nonzero[i] = p.nonzero_requests()
            limits[i, 0] = p.limits.cpu_milli
            limits[i, 1] = p.limits.memory
            if p.node_name:
                nid = u.node_names.lookup(p.node_name)
                # -2 = pinned to a node that does not exist: PodFitsHost
                # (predicates.go:916) must fail on every node, unlike -1
                # ("no requirement")
                name_req[i] = nid if nid >= 0 else -2
            priority[i] = p.priority
            for proto, ip, port in p.host_ports:
                ppi = u.ports_pp.intern((proto, port))
                if not ip or ip == "0.0.0.0":
                    port_wild_pp[i, ppi] = 1
                else:
                    port_spec_pp[i, ppi] = 1
                    port_spec_pip[i, u.ports_pip.intern((proto, ip, port))] = 1
            for img in p.images:
                ii = u.images.lookup(img)
                if ii >= 0:
                    image_mh[i, ii] = 1
            if p.owner_uid:
                # lookup, not intern: widths are frozen for this pack; the
                # uid was interned on arrival (intern_pod)
                owner_uid[i] = u.owner_uids.lookup(p.owner_uid)
            for o in _matching_owner_sets(u, p):
                owner_match[i, o] = 1
            if p.volumes:
                rv = self.resolve_volumes(p)
                vol_error[i] = rv.error
                for kind, handle, ro in rv.conflict:
                    cid = u.vol_conflict.lookup((kind, handle))
                    vol_any[i, cid] = 1
                    if not ro:
                        vol_rw[i, cid] = 1
                for fi, tok in rv.pd:
                    pd_mh[i, u.pd_volumes.lookup((fi, tok))] = 1
                for driver, handle in rv.csi:
                    d = u.csi_drivers.lookup(driver)
                    csi_mh[i, u.csi_volumes.lookup((d, handle))] = 1

        return PodTable(
            n=n,
            req=req,
            nonzero_req=nonzero,
            selprog_id=selprog,
            prefprog_id=prefprog,
            tolset_id=tolset,
            name_req=name_req,
            priority=priority,
            port_wild_pp=port_wild_pp,
            port_spec_pp=port_spec_pp,
            port_spec_pip=port_spec_pip,
            image_mh=image_mh,
            owner_id=owner,
            owner_uid_id=owner_uid,
            owner_match_mh=owner_match,
            order=np.arange(n, dtype=np.int32),
            matcher_mh=matcher_mh,
            affprog_id=affprog,
            prefaffprog_id=prefaffprog,
            spread_hard_id=spread_hard,
            spread_soft_id=spread_soft,
            self_aff_match=self_aff,
            anti_term_mh=anti_term_mh,
            sym_term_mh=sym_term_mh,
            has_aff=has_aff,
            vol_any_mh=vol_any,
            vol_rw_mh=vol_rw,
            pd_mh=pd_mh,
            csi_mh=csi_mh,
            vol_error=vol_error,
            limits=limits,
        )

    # -- volume tables -----------------------------------------------------

    def pack_volume_tables(self, pods: Sequence[Pod]) -> VolumeTables:
        """Universe volume metadata + zone/binding constraint rows for this
        pending batch (row indices reference the batch's row order, which
        must match the ``pack_pods`` call for the same sequence).
        Memoized like pack_pods — the signature's pack epoch covers every
        volume-state / claim-lifecycle invalidation."""
        ids = tuple((p.key(), p.uid) for p in pods)
        key = (ids, self.universe_sig())
        hit = self._memo_get(self._vol_table_memo, key)
        if hit is not None:
            return hit
        table = self._pack_volume_tables_uncached(pods)
        self._memo_put(self._vol_table_memo, (ids, self.universe_sig()),
                       table)
        return table

    def _pack_volume_tables_uncached(self, pods: Sequence[Pod]) -> VolumeTables:
        u = self.u
        w = self.widths()
        esc = np.zeros((w["Uv"],), np.float32)
        esc[: len(u.vol_conflict_escape)] = np.asarray(
            u.vol_conflict_escape, np.float32
        )
        pd_type = np.zeros((w["Uvd"],), np.int32)
        for t, (fi, _tok) in enumerate(u.pd_volumes.items()):
            pd_type[t] = fi
        csi_driver = np.zeros((w["Uvc"],), np.int32)
        for t, (d, _h) in enumerate(u.csi_volumes.items()):
            csi_driver[t] = d

        vz_pod: List[int] = []
        vz_rows: List[List[int]] = []
        vb_row_clause: List[int] = []
        vb_row_prog: List[int] = []
        vb_clause_pod: List[int] = []
        vb_clause_bound: List[bool] = []
        for i, p in enumerate(pods):
            if not p.volumes:
                continue
            rv = self.resolve_volumes(p)
            for key, allowed in rv.zone_rows:
                ids = (u.label_pairs.lookup((key, z)) for z in allowed)
                pair_ids = [pid for pid in ids if pid >= 0]
                vz_pod.append(i)
                vz_rows.append(pair_ids)
            for terms in rv.bound_affinity:
                cid = len(vb_clause_pod)
                vb_clause_pod.append(i)
                vb_clause_bound.append(True)
                vb_row_clause.append(cid)
                vb_row_prog.append(u.pv_affinity_program(terms))
            for cands in rv.unbound_clauses:
                if any(not t for t in cands):
                    continue  # an unconstrained candidate satisfies any node
                cid = len(vb_clause_pod)
                vb_clause_pod.append(i)
                vb_clause_bound.append(False)
                for terms in cands:
                    vb_row_clause.append(cid)
                    vb_row_prog.append(u.pv_affinity_program(terms))

        Rv = len(vz_pod)
        vz_pairs = np.zeros((Rv, w["Up"]), np.int8)
        for r, ids in enumerate(vz_rows):
            for pid in ids:
                vz_pairs[r, pid] = 1
        i32 = lambda x: np.asarray(x, np.int32)
        return VolumeTables(
            conflict_escape=esc,
            pd_type=pd_type,
            csi_driver=csi_driver,
            n_csi_drivers=len(u.csi_drivers),
            vz_n_rows=Rv,
            vz_pod=i32(vz_pod),
            vz_pairs_mh=vz_pairs,
            vb_n_rows=len(vb_row_clause),
            vb_n_clauses=len(vb_clause_pod),
            vb_row_clause=i32(vb_row_clause),
            vb_row_prog=i32(vb_row_prog),
            vb_clause_pod=i32(vb_clause_pod),
            vb_clause_bound=np.asarray(vb_clause_bound, bool),
        )

    # -- selector / toleration tables --------------------------------------

    def pack_selector_tables(self) -> SelectorTables:
        u = self.u
        w = self.widths()

        def flatten(programs, weighted: bool):
            expr_term: List[int] = []
            expr_op: List[int] = []
            expr_pairs: List[Tuple[int, ...]] = []
            expr_key: List[int] = []
            expr_lit: List[float] = []
            term_prog: List[int] = []
            term_weight: List[float] = []
            for prog_id, terms in enumerate(programs):
                for term in terms:
                    if weighted:
                        weight, exprs = term
                    else:
                        weight, exprs = 1.0, term
                    tid = len(term_prog)
                    term_prog.append(prog_id)
                    term_weight.append(weight)
                    for e in exprs:
                        expr_term.append(tid)
                        expr_op.append(e.op)
                        expr_pairs.append(e.pair_ids)
                        expr_key.append(e.key_id)
                        expr_lit.append(e.literal)
            E, T = len(expr_term), len(term_prog)
            pairs_mh = np.zeros((E, w["Up"]), np.int8)
            for r, ids in enumerate(expr_pairs):
                for pid in ids:
                    pairs_mh[r, pid] = 1
            return (
                E,
                T,
                len(programs),
                np.asarray(expr_term, np.int32),
                np.asarray(expr_op, np.int32),
                pairs_mh,
                np.asarray(expr_key, np.int32),
                np.asarray(expr_lit, np.float32),
                np.asarray(term_prog, np.int32),
                np.asarray(term_weight, np.float32),
            )

        (E, T, G, e_t, e_op, e_p, e_k, e_l, t_p, _) = flatten(
            u.sel_program_terms, weighted=False
        )
        (pE, pT, pG, pe_t, pe_op, pe_p, pe_k, pe_l, pt_p, pt_w) = flatten(
            u.pref_program_terms, weighted=True
        )

        # tolerated-taint multihots per toleration set
        S = len(u.tol_set_items)
        Ut = w["Ut"]
        tol_hard = np.zeros((S, Ut), np.int8)
        tol_soft = np.zeros((S, Ut), np.int8)
        taint_items = u.taints.items()
        from kubernetes_tpu_torch.api.types import Taint  # local to avoid cycle noise

        for s, tols in enumerate(u.tol_set_items):
            for ti, (tk, tv, te) in enumerate(taint_items):
                taint = Taint(tk, tv, te)
                if any(t.tolerates(taint) for t in tols):
                    if te in (EFFECT_NO_SCHEDULE, EFFECT_NO_EXECUTE):
                        tol_hard[s, ti] = 1
                    elif te == EFFECT_PREFER_NO_SCHEDULE:
                        tol_soft[s, ti] = 1

        sizes = np.zeros((w["Ui"],), np.float32)
        sizes[: len(u.image_sizes)] = np.asarray(u.image_sizes, np.float32)

        return SelectorTables(
            n_exprs=E,
            n_terms=T,
            n_progs=G,
            expr_term=e_t,
            expr_op=e_op,
            expr_pairs_mh=e_p,
            expr_key=e_k,
            expr_lit=e_l,
            term_prog=t_p,
            p_n_exprs=pE,
            p_n_terms=pT,
            p_n_progs=pG,
            p_expr_term=pe_t,
            p_expr_op=pe_op,
            p_expr_pairs_mh=pe_p,
            p_expr_key=pe_k,
            p_expr_lit=pe_l,
            p_term_prog=pt_p,
            p_term_weight=pt_w,
            tol_hard_mh=tol_hard,
            tol_soft_mh=tol_soft,
            image_sizes=sizes,
        )

    # -- topology / inter-pod affinity tables ------------------------------

    def pack_topology_tables(self) -> TopologyTables:
        u = self.u
        w = self.widths()

        def flat(progs_rows, with_extra: bool):
            prog_l: List[int] = []
            key_l: List[int] = []
            m_l: List[int] = []
            extra_l: List[float] = []
            for pid, rows in enumerate(progs_rows):
                for row in rows:
                    prog_l.append(pid)
                    key_l.append(row[0])
                    m_l.append(row[1])
                    if with_extra:
                        extra_l.append(float(row[2]))
            return prog_l, key_l, m_l, extra_l

        # required rows: extra = is_anti
        ra_prog, ra_key, ra_m, ra_anti = flat(u.aff_program_rows, True)
        rp_prog, rp_key, rp_m, rp_w = flat(u.pref_aff_program_rows, True)

        Ua, Us = w["Ua"], w["Us"]
        # padding rows MUST carry matcher -1: a zero-filled row aliases
        # (key 0, matcher 0) — real interned ids — and every pod matching
        # matcher 0 would spuriously read as anti-term-matched. That
        # aliasing made sensitive_keys() flag ALL soft-spread/affinity
        # pods and serialize admissions to one per topology pair per
        # round (206 rounds for a 2048-pod soft-spread batch, round-3
        # profiling; the round-2 "topology kernels are the slow path"
        # finding was THIS, not kernel cost).
        at_key = np.full((Ua,), -1, np.int32)
        at_m = np.full((Ua,), -1, np.int32)
        for a, (k, m) in enumerate(u.anti_terms.items()):
            at_key[a], at_m[a] = k, m
        st_key = np.full((Us,), -1, np.int32)
        st_m = np.full((Us,), -1, np.int32)
        st_w = np.zeros((Us,), np.float32)
        st_hard = np.zeros((Us,), np.float32)
        for s, (k, m, wt, kind) in enumerate(u.sym_terms.items()):
            st_key[s], st_m[s] = k, m
            if kind == SYM_HARD_AFF:
                st_hard[s] = 1.0
            elif kind == SYM_SOFT_AFF:
                st_w[s] = wt
            else:
                st_w[s] = -wt

        sh_prog: List[int] = []
        sh_key: List[int] = []
        sh_m: List[int] = []
        sh_skew: List[float] = []
        shp_sel: List[int] = []
        for pid, (rows, selprog) in enumerate(u.spread_hard_program_rows):
            shp_sel.append(selprog)
            for (k, m, skew) in rows:
                sh_prog.append(pid)
                sh_key.append(k)
                sh_m.append(m)
                sh_skew.append(float(skew))
        ss_prog: List[int] = []
        ss_key: List[int] = []
        ss_m: List[int] = []
        ssp_sel: List[int] = []
        for pid, (rows, selprog) in enumerate(u.spread_soft_program_rows):
            ssp_sel.append(selprog)
            for (k, m) in rows:
                ss_prog.append(pid)
                ss_key.append(k)
                ss_m.append(m)

        i32 = lambda x: np.asarray(x, np.int32)
        f32 = lambda x: np.asarray(x, np.float32)
        return TopologyTables(
            n_pairs=len(u.topo_pairs),
            n_matchers=w["M"],
            ra_n_rows=len(ra_prog),
            ra_n_progs=len(u.aff_program_rows),
            ra_prog=i32(ra_prog),
            ra_key=i32(ra_key),
            ra_m=i32(ra_m),
            ra_anti=np.asarray(ra_anti, bool) if ra_anti else np.zeros((0,), bool),
            rp_n_rows=len(rp_prog),
            rp_n_progs=len(u.pref_aff_program_rows),
            rp_prog=i32(rp_prog),
            rp_key=i32(rp_key),
            rp_m=i32(rp_m),
            rp_w=f32(rp_w),
            at_key=at_key,
            at_m=at_m,
            st_key=st_key,
            st_m=st_m,
            st_w=st_w,
            st_hard=st_hard,
            sh_n_rows=len(sh_prog),
            sh_n_progs=len(u.spread_hard_program_rows),
            sh_prog=i32(sh_prog),
            sh_key=i32(sh_key),
            sh_m=i32(sh_m),
            sh_skew=f32(sh_skew),
            shp_selprog=i32(shp_sel),
            ss_n_rows=len(ss_prog),
            ss_n_progs=len(u.spread_soft_program_rows),
            ss_prog=i32(ss_prog),
            ss_key=i32(ss_key),
            ss_m=i32(ss_m),
            ssp_selprog=i32(ssp_sel),
        )
