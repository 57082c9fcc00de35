"""Inter-pod affinity and topology-spread passes (the port of
``kubernetes_tpu/ops/topology.py``):

- ``InterPodAffinityMatches`` (predicates.go:1211): required pod
  (anti)affinity of the incoming pod AND the symmetric check that no
  *existing* pod's required anti-affinity forbids the incoming pod,
  including the first-pod-of-a-group self-match escape
  (predicates.go:1437).
- ``EvenPodsSpreadPredicate`` (predicates.go:1720): hard maxSkew
  constraints with the candidate-node minimum of
  ``getTPMapMatchingSpreadConstraints`` (metadata.go:194).
- ``CalculateInterPodAffinityPriority`` (interpod_affinity.go:46) with
  full symmetry (existing pods' hard/soft terms scoring the incoming pod).
- ``CalculateEvenPodsSpreadPriority`` (even_pods_spread.go:86).

Topology *pairs* (key, value) are interned on the host; each node carries
``topo_pair_id (N, K)``, its pair per topology key. The counts the
reference keeps in ``topologyPairsMaps`` (metadata.go:65) are segment sums
over the node axis of the per-node count matrices (``matcher_counts`` /
``anti_counts`` / ``sym_counts``), which the round loop scatter-adds as
pods land. Matcher-id gathers are one-hot matmuls against the (., M)
count matrices; the K loops are unrolled over the padded key count.

Every count is an integer-valued f32 below 2^24, so the matmuls (TF32 is
off), the ``index_add_`` sums (whose order on CUDA is not fixed) and the
signed preferred weights are exact, and the results equal the reference's
bit for bit. Every gather either clips its index or reads a dump row, as
the reference does.
"""

from __future__ import annotations

from typing import Tuple

import torch

from kubernetes_tpu_torch.ops.arrays import (
    DeviceNodes,
    DevicePods,
    DeviceTopology,
)
from kubernetes_tpu_torch.ops.predicates import _segment_max, _segment_min

Tensor = torch.Tensor

_INF = 3e38


def _segment_sum(data: Tensor, ids: Tensor, n: int) -> Tensor:
    """jax.ops.segment_sum over rows (every id lies in ``[0, n)``)."""
    out = torch.zeros((n,) + data.shape[1:], dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, ids.long(), data)


def _dump(idx: Tensor, n_pairs: int) -> Tensor:
    """Pair ids with absent keys (-1) routed to the dump row ``n_pairs``."""
    return torch.where(idx >= 0, idx, n_pairs).long()


def _group_counts(topo_pair_id: Tensor, counts: Tensor,
                  n_pairs: int) -> Tensor:
    """G[tp, c] = sum of counts[n, c] over nodes n whose pair set includes
    tp. Output has ``n_pairs + 1`` rows; the last row is a dump for nodes
    lacking a key."""
    G = torch.zeros((n_pairs + 1, counts.shape[1]), dtype=torch.float32,
                    device=counts.device)
    for k in range(topo_pair_id.shape[1]):
        G.index_add_(0, _dump(topo_pair_id[:, k], n_pairs), counts)
    return G


def _row_counts(G: Tensor, topo_pair_id: Tensor, row_key: Tensor,
                row_m_onehot: Tensor) -> Tuple[Tensor, Tensor]:
    """Per term-row t (topology key row_key[t], matcher one-hot row) and
    node n: the matcher count within n's topology group of that key.
    Returns (cnt (T, N), has_key (T, N))."""
    N, K = topo_pair_id.shape
    T = row_key.shape[0]
    n_pairs = G.shape[0] - 1
    cnt = torch.zeros((T, N), dtype=torch.float32, device=G.device)
    has = torch.zeros((T, N), dtype=torch.bool, device=G.device)
    for k in range(K):
        idx = topo_pair_id[:, k]
        hk = idx >= 0
        cnt_k = row_m_onehot @ G[_dump(idx, n_pairs)].T  # (T, N)
        rs = (row_key == k)[:, None]
        cnt = torch.where(rs, torch.where(hk[None, :], cnt_k, 0.0), cnt)
        has = torch.where(rs, hk[None, :], has)
    return cnt, has


def _col_gather(Gc: Tensor, topo_pair_id: Tensor, col_key: Tensor) -> Tensor:
    """(N, C): Gc[topo_pair_id[n, col_key[c]], c]; 0 where the node lacks
    column c's key. Gc is (n_pairs+1, C) with per-column keys."""
    N, K = topo_pair_id.shape
    n_pairs = Gc.shape[0] - 1
    out = torch.zeros((N, col_key.shape[0]), dtype=torch.float32,
                      device=Gc.device)
    for k in range(K):
        idx = topo_pair_id[:, k]
        cm = (col_key == k)[None, :]
        out = torch.where(cm & (idx >= 0)[:, None], Gc[_dump(idx, n_pairs)],
                          out)
    return out


def _has_key_rows(topo_pair_id: Tensor, row_key: Tensor) -> Tensor:
    """(T, N) bool: node has topology key row_key[t]."""
    N, K = topo_pair_id.shape
    has = torch.zeros((row_key.shape[0], N), dtype=torch.bool,
                      device=topo_pair_id.device)
    for k in range(K):
        hk = topo_pair_id[:, k] >= 0
        has = torch.where((row_key == k)[:, None], hk[None, :], has)
    return has


def _seg_all(flags: Tensor, seg: Tensor, num: int) -> Tensor:
    """Segmented AND with neutral True (an empty segment's int32 max)."""
    return _segment_min(flags.to(torch.int32), seg, num) > 0


def _seg_any(flags: Tensor, seg: Tensor, num: int) -> Tensor:
    """Segmented OR with neutral False (an empty segment's int32 min)."""
    return _segment_max(flags.to(torch.int32), seg, num) > 0


def _prog_escape(nodes: DeviceNodes, topo: DeviceTopology, has: Tensor):
    """Per affinity program: (prog_empty, prog_has_aff), both (Ga+1,).
    ``prog_empty``: no existing pod matches any of the program's affinity
    rows on a keyed node (the self-match escape's precondition)."""
    mc_tot = torch.where(has, topo.ra_m_onehot @ nodes.matcher_counts.T,
                         0.0).sum(1)  # (Ta,) matching pods over keyed nodes
    num = topo.ga_valid.shape[0] + 1
    is_aff = topo.ra_valid & ~topo.ra_anti
    prog_empty = _seg_all(~is_aff | (mc_tot <= 0.5), topo.ra_prog, num)
    prog_has_aff = _seg_any(is_aff, topo.ra_prog, num)
    return prog_empty, prog_has_aff


def inter_pod_affinity_mask(pods: DevicePods, nodes: DeviceNodes,
                            topo: DeviceTopology) -> Tensor:
    """(P, N) bool — InterPodAffinityMatches (predicates.go:1211)."""
    n_pairs = topo.pair_valid.shape[0]
    tpid = nodes.topo_pair_id

    # (a) existing pods' required anti-affinity vs the incoming pod
    # (satisfiesExistingPodsAntiAffinity): node fails when any of its
    # topology pairs holds a pod whose anti-term matches the incoming pod
    A = _group_counts(tpid, nodes.anti_counts, n_pairs)  # (Utp+1, Ua)
    AG = _col_gather(A, tpid, topo.at_key)  # (N, Ua)
    pm_anti = pods.matcher_mh @ topo.at_m_onehot.T  # (P, Ua)
    ok = (pm_anti @ AG.T) <= 0.5  # (P, N)

    # (b) the incoming pod's own required terms
    G = _group_counts(tpid, nodes.matcher_counts, n_pairs)  # (Utp+1, M)
    cnt, has = _row_counts(G, tpid, topo.ra_key, topo.ra_m_onehot)
    n_progs = topo.ga_valid.shape[0]
    seg = topo.ra_prog  # pad rows -> n_progs (dump)
    num = n_progs + 1
    is_aff = topo.ra_valid & ~topo.ra_anti
    is_anti = topo.ra_valid & topo.ra_anti
    row_hit = has & (cnt > 0.5)

    # the reference merges a pod's term matches into ONE pair map keyed by
    # (topologyKey, value): term t passes at node n if ANY same-key term of
    # the same program hit n's pair — OR row hits within (program, key)
    K = tpid.shape[1]
    seg2 = (seg * K + topo.ra_key).long()  # (prog, key) group id
    num2 = num * K
    aff_pair = _seg_any(row_hit & is_aff[:, None], seg2, num2)  # (num2, N)
    anti_pair = _seg_any(row_hit & is_anti[:, None], seg2, num2)

    # nodeMatchesAllTopologyTerms: every affinity row's (key, value) pair
    # is populated; anti rows are neutral-True here
    aff_all = _seg_all(~is_aff[:, None] | (has & aff_pair[seg2]), seg, num)
    # nodeMatchesAnyTopologyTerm for anti rows
    anti_any = _seg_any(is_anti[:, None] & has & anti_pair[seg2], seg, num)

    # self-match escape: the merged affinity-pair map is empty AND the pod
    # matches its own terms (predicates.go:1437)
    prog_empty, prog_has_aff = _prog_escape(nodes, topo, has)

    gid = pods.affprog_id.clamp(0, n_progs).long()
    has_prog = pods.affprog_id >= 0
    aff_ok = (~prog_has_aff[gid][:, None] | aff_all[gid]
              | (prog_empty[gid] & pods.self_aff_match)[:, None])
    anti_ok = ~anti_any[gid]
    return ok & (~has_prog[:, None] | (aff_ok & anti_ok))


def _spread_candidates(sel_match: Tensor, nodes: DeviceNodes,
                       prog_selprog: Tensor, row_prog: Tensor,
                       row_key: Tensor, row_valid: Tensor):
    """Per spread program: (cand, keys_ok), both (Gs+1, N). ``cand`` =
    nodes that count toward pair totals/min: pass the pod's node selector
    AND carry every constraint's topology key (metadata.go:232-238).
    ``keys_ok`` = key presence alone (the soft score's eligibility)."""
    n_selprogs = sel_match.shape[0]
    Gs = prog_selprog.shape[0]
    sel_ok = (prog_selprog < 0)[:, None] | sel_match[
        prog_selprog.clamp(0, n_selprogs - 1).long()]  # (Gs, N)
    has = _has_key_rows(nodes.topo_pair_id, row_key)  # (T, N)
    keys_ok = _seg_all(~row_valid[:, None] | has, row_prog, Gs + 1) \
        & nodes.valid[None, :]  # (Gs+1, N)
    dump = torch.zeros((1, sel_ok.shape[1]), dtype=torch.bool,
                       device=sel_ok.device)
    cand = keys_ok & torch.cat([sel_ok, dump])
    return cand, keys_ok


def _spread_pair_counts(nodes: DeviceNodes, topo_n_pairs: int,
                        cand_row: Tensor, row_key: Tensor,
                        row_m_onehot: Tensor) -> Tuple[Tensor, Tensor]:
    """Per row t and pair tp: (matching-pod count, candidate-node count),
    accumulated over candidate nodes only. Returns (C, Pres), both
    (n_pairs+1, T)."""
    tpid = nodes.topo_pair_id
    mc = row_m_onehot @ nodes.matcher_counts.T  # (T, N)
    vals = torch.where(cand_row, mc, 0.0).T  # (N, T)
    pres = cand_row.to(torch.float32).T
    T = row_key.shape[0]
    C = torch.zeros((topo_n_pairs + 1, T), dtype=torch.float32,
                    device=mc.device)
    Pres = torch.zeros_like(C)
    for k in range(tpid.shape[1]):
        idx = _dump(tpid[:, k], topo_n_pairs)
        colk = (row_key == k)[None, :]
        C.index_add_(0, idx, torch.where(colk, vals, 0.0))
        Pres.index_add_(0, idx, torch.where(colk, pres, 0.0))
    return C, Pres


def _pair_gather_rows(C: Tensor, tpid: Tensor, row_key: Tensor) -> Tensor:
    """cnt (T, N): C[topo_pair_id[n, k_t], t]; 0 where key absent."""
    N, K = tpid.shape
    n_pairs = C.shape[0] - 1
    out = torch.zeros((row_key.shape[0], N), dtype=torch.float32,
                      device=C.device)
    for k in range(K):
        idx = tpid[:, k]
        rs = (row_key == k)[:, None]
        out = torch.where(rs & (idx >= 0)[None, :], C[_dump(idx, n_pairs)].T,
                          out)
    return out


def even_pods_spread_mask(pods: DevicePods, nodes: DeviceNodes,
                          topo: DeviceTopology, sel_match: Tensor) -> Tensor:
    """(P, N) bool — EvenPodsSpreadPredicate (predicates.go:1720):
    matchNum + selfMatch - minMatchNum <= maxSkew per hard constraint.
    ``sel_match`` (Gsel, N) is the required-selector program table."""
    n_pairs = topo.pair_valid.shape[0]
    tpid = nodes.topo_pair_id
    Gsh = topo.shp_valid.shape[0]

    cand, _ = _spread_candidates(sel_match, nodes, topo.shp_selprog,
                                 topo.sh_prog, topo.sh_key, topo.sh_valid)
    cand_row = cand[topo.sh_prog.long()]  # (Tsh, N)
    C, Pres = _spread_pair_counts(nodes, n_pairs, cand_row, topo.sh_key,
                                  topo.sh_m_onehot)
    # min match per row over pairs seen on candidate nodes (metadata.go:285);
    # rows with no candidate pairs keep +INF -> the skew check passes
    minm = torch.where(Pres[:n_pairs] > 0.5, C[:n_pairs], _INF).amin(0)
    cntn = _pair_gather_rows(C, tpid, topo.sh_key)  # (Tsh, N)
    has = _has_key_rows(tpid, topo.sh_key)
    thr = torch.clamp_max(minm + topo.sh_skew, _INF)[:, None]  # (Tsh, 1)
    ok0 = cntn <= thr + 0.5  # selfMatch = 0
    ok1 = cntn + 1.0 <= thr + 0.5  # selfMatch = 1
    sh_valid = topo.sh_valid[:, None]
    fail0 = sh_valid & (~has | ~ok0)  # (Tsh, N)
    d = (sh_valid & (~has | ~ok1) & ~fail0).to(torch.float32)
    F0 = _seg_any(fail0, topo.sh_prog, Gsh + 1)  # (Gsh+1, N)

    self_m = pods.matcher_mh @ topo.sh_m_onehot.T  # (P, Tsh)
    own_row = pods.spread_hard_id[:, None] == topo.sh_prog[None, :]
    extra = torch.where(own_row, self_m, 0.0) @ d  # (P, N)

    gid = pods.spread_hard_id.clamp(0, Gsh).long()
    fail = F0[gid] | (extra > 0.5)
    return (pods.spread_hard_id < 0)[:, None] | ~fail


def even_pods_spread_score(pods: DevicePods, nodes: DeviceNodes,
                           topo: DeviceTopology, sel_match: Tensor,
                           mask: Tensor) -> Tensor:
    """(P, N) f32 — CalculateEvenPodsSpreadPriority
    (even_pods_spread.go:86): 10 * (total - count) / (total - min), over
    the filtered candidate nodes ``mask``."""
    n_pairs = topo.pair_valid.shape[0]
    tpid = nodes.topo_pair_id
    Gss = topo.ssp_valid.shape[0]

    cand, keys_ok = _spread_candidates(sel_match, nodes, topo.ssp_selprog,
                                       topo.ss_prog, topo.ss_key,
                                       topo.ss_valid)
    cand_row = cand[topo.ss_prog.long()]
    C, _ = _spread_pair_counts(nodes, n_pairs, cand_row, topo.ss_key,
                               topo.ss_m_onehot)
    cntn = _pair_gather_rows(C, tpid, topo.ss_key)  # (Tss, N)
    # per-program per-node credit: sum of pair counts over its constraints
    CS = _segment_sum(torch.where(topo.ss_valid[:, None], cntn, 0.0),
                      topo.ss_prog, Gss + 1)  # (Gss+1, N)

    gid = pods.spread_soft_id.clamp(0, Gss).long()
    cnt_p = CS[gid]  # (P, N)
    # scoring eligibility: filtered nodes with every topology key present —
    # the selector is NOT re-checked here (initialize() vs processAllNode
    # asymmetry in even_pods_spread.go)
    el = keys_ok[gid] & mask
    total = torch.where(el, cnt_p, 0.0).sum(1, keepdim=True)  # (P, 1)
    minc = torch.where(el, cnt_p, _INF).amin(1, keepdim=True)
    any_el = el.any(1, keepdim=True)
    diff = total - torch.where(any_el, minc, 0.0)
    score = torch.where(
        diff > 0,
        torch.floor(10.0 * (total - cnt_p) / torch.clamp_min(diff, 1e-30)
                    + 1e-5),
        10.0)
    score = torch.where(el, score, 0.0)
    return torch.where((pods.spread_soft_id >= 0)[:, None], score, 0.0)


def _key_onehot(keys: Tensor, K: int) -> Tensor:
    """(T, K) f32 one-hot of per-row topology-key indices."""
    ar = torch.arange(K, device=keys.device)
    return (keys[:, None] == ar[None, :]).to(torch.float32)


def sensitive_keys(pods: DevicePods, topo: DeviceTopology, K: int) -> Tensor:
    """(P, K) bool: topology keys along which admitting this pod in the
    same round as another pod of the same topology group could violate a
    required anti-affinity or hard-spread constraint (either direction).
    The batch solver serializes such admissions per topology pair per
    round. Keys of *affinity* terms are excluded: affinity counts only
    grow (the self-match escape is :func:`self_escape_active`'s)."""
    n_progs = topo.ga_valid.shape[0]
    Gsh = topo.shp_valid.shape[0]

    # own required anti-affinity keys, via the pod's program
    anti_rows = (topo.ra_valid & topo.ra_anti).to(torch.float32)[:, None] \
        * _key_onehot(topo.ra_key, K)  # (Ta, K)
    prog_anti = _segment_sum(anti_rows, topo.ra_prog, n_progs + 1) > 0.5
    own_anti = (pods.affprog_id >= 0)[:, None] & prog_anti[
        pods.affprog_id.clamp(0, n_progs).long()]
    # own hard-spread keys
    sh_rows = topo.sh_valid.to(torch.float32)[:, None] \
        * _key_onehot(topo.sh_key, K)
    prog_sh = _segment_sum(sh_rows, topo.sh_prog, Gsh + 1) > 0.5
    own_sh = (pods.spread_hard_id >= 0)[:, None] & prog_sh[
        pods.spread_hard_id.clamp(0, Gsh).long()]
    # keys of universe anti-terms whose matcher matches this pod (the pod
    # could break an already-admitted pod's anti constraint)
    pm_anti = pods.matcher_mh @ topo.at_m_onehot.T  # (P, Ua)
    match_anti = (pm_anti @ _key_onehot(topo.at_key, K)) > 0.5
    # keys of hard-spread rows whose selector matches this pod (its landing
    # shifts another pod's skew within the round)
    pm_sh = (pods.matcher_mh @ topo.sh_m_onehot.T) \
        * topo.sh_valid[None, :].to(torch.float32)
    match_sh = (pm_sh @ _key_onehot(topo.sh_key, K)) > 0.5
    return own_anti | own_sh | match_anti | match_sh


def self_escape_active(pods: DevicePods, nodes: DeviceNodes,
                       topo: DeviceTopology) -> Tensor:
    """(P,) bool: the pod's required-affinity check passes via the
    first-pod-of-a-group escape (empty pair map + self match) under the
    CURRENT counts. Two escapees of one program must not be admitted in
    the same round — the second must join the first's topology group."""
    has = _has_key_rows(nodes.topo_pair_id, topo.ra_key)  # (Ta, N)
    prog_empty, prog_has_aff = _prog_escape(nodes, topo, has)
    gid = pods.affprog_id.clamp(0, topo.ga_valid.shape[0]).long()
    return ((pods.affprog_id >= 0) & prog_has_aff[gid] & prog_empty[gid]
            & pods.self_aff_match)


def inter_pod_affinity_score(pods: DevicePods, nodes: DeviceNodes,
                             topo: DeviceTopology, mask: Tensor,
                             hard_pod_affinity_weight: float = 1.0) -> Tensor:
    """(P, N) f32 — CalculateInterPodAffinityPriority
    (interpod_affinity.go): weighted term counts (incoming preferred terms
    + symmetric existing-pod terms), min/max-normalized to 0..10 per pod
    over feasible nodes."""
    n_pairs = topo.pair_valid.shape[0]
    tpid = nodes.topo_pair_id
    Gp = topo.gp_valid.shape[0]

    # incoming pod's preferred terms: +/-w per matching existing pod in the
    # node's topology group of the term's key
    G = _group_counts(tpid, nodes.matcher_counts, n_pairs)
    cnt, has = _row_counts(G, tpid, topo.rp_key, topo.rp_m_onehot)  # (Tp, N)
    w_cnt = topo.rp_w[:, None] * torch.where(has, cnt, 0.0)
    S_in = _segment_sum(torch.where(topo.rp_valid[:, None], w_cnt, 0.0),
                        topo.rp_prog, Gp + 1)  # (Gp+1, N)
    gid = pods.prefaffprog_id.clamp(0, Gp).long()
    score_in = torch.where((pods.prefaffprog_id >= 0)[:, None], S_in[gid],
                           0.0)

    # symmetry: existing pods' hard-affinity (x hardPodAffinityWeight),
    # soft-affinity (+w) and soft-anti-affinity (-w) terms that match the
    # incoming pod, credited to the existing pod's whole topology group
    S = _group_counts(tpid, nodes.sym_counts, n_pairs)  # (Utp+1, Us)
    SG = _col_gather(S, tpid, topo.st_key)  # (N, Us)
    pm_sym = pods.matcher_mh @ topo.st_m_onehot.T  # (P, Us)
    w_eff = topo.st_w + topo.st_hard * hard_pod_affinity_weight  # (Us,)
    score_sym = (pm_sym * w_eff[None, :]) @ SG.T  # (P, N)

    counts = score_in + score_sym
    # "counted" nodes (pm.counts non-nil): pod has (anti)affinity, or the
    # node hosts pods with affinity (interpod_affinity.go:121-127)
    counted = pods.has_aff[:, None] | (nodes.aff_pod_count > 0.5)[None, :]
    el = mask & counted
    z = torch.where(el, counts, 0.0)
    mx = torch.clamp_min(z.amax(1, keepdim=True), 0.0)
    mn = torch.clamp_max(z.amin(1, keepdim=True), 0.0)
    diff = mx - mn
    return torch.where(
        (diff > 0) & counted,
        torch.floor(10.0 * torch.clamp_min(counts - mn, 0.0)
                    / torch.clamp_min(diff, 1e-30) + 1e-5),
        0.0)
