"""Device-side table bundles (NamedTuples of tensors) mirroring the host
columnar tables, padded to power-of-two row buckets so shapes stay
stable as the cluster and the pending queue grow and shrink (the port of
``kubernetes_tpu/ops/arrays.py``; same field names and dtypes).

Index fields stay int32 as in the reference; they are cast to ``long``
only where they index."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from kubernetes_tpu_torch import resolve_device
from kubernetes_tpu_torch.snapshot import (
    NodeTable,
    PodTable,
    SelectorTables,
    VolumeTables,
)
from kubernetes_tpu_torch.utils.interner import bucket_size

Tensor = torch.Tensor


class DeviceNodes(NamedTuple):
    """Padded columnar NodeInfo on device. Rows >= n_valid are padding and
    are marked unschedulable so every predicate rejects them."""

    valid: Tensor  # (N,) bool
    name_id: Tensor  # (N,) i32
    allocatable: Tensor  # (N, R) f32
    requested: Tensor  # (N, R) f32
    nonzero_req: Tensor  # (N, 2) f32
    pair_mh: Tensor  # (N, Up) f32 (f32 so memberships are matmuls)
    key_mh: Tensor  # (N, Uk) f32
    key_val: Tensor  # (N, Uk) f32
    key_num: Tensor  # (N, Uk) f32 — 1 when label parsed as integer
    taint_hard_mh: Tensor  # (N, Ut) f32
    taint_soft_mh: Tensor  # (N, Ut) f32
    port_any_mh: Tensor  # (N, Upp) f32
    port_wild_mh: Tensor  # (N, Upp) f32
    port_spec_mh: Tensor  # (N, Upip) f32
    image_mh: Tensor  # (N, Ui) f32
    owner_counts: Tensor  # (N, Uo) f32
    zone_id: Tensor  # (N,) i32
    zone_valid: Tensor  # (Z,) bool — padded zone count
    avoid_mh: Tensor  # (N, Uu) f32
    ready: Tensor  # (N,) bool
    network_unavailable: Tensor  # (N,) bool
    schedulable: Tensor  # (N,) bool
    mem_pressure: Tensor  # (N,) bool
    disk_pressure: Tensor  # (N,) bool
    pid_pressure: Tensor  # (N,) bool
    topo_pair_id: Tensor  # (N, K) i32 — -1 = key absent
    matcher_counts: Tensor  # (N, M) f32
    anti_counts: Tensor  # (N, Ua) f32
    sym_counts: Tensor  # (N, Us) f32
    aff_pod_count: Tensor  # (N,) f32
    vol_any_mh: Tensor  # (N, Uv) f32
    vol_rw_mh: Tensor  # (N, Uv) f32
    pd_mh: Tensor  # (N, Uvd) f32
    pd_limit: Tensor  # (N, 4) f32
    csi_mh: Tensor  # (N, Uvc) f32
    csi_limit: Tensor  # (N, Dc) f32 — +inf = no limit
    has_zone_label: Tensor  # (N,) bool

    @property
    def n(self) -> int:
        return self.name_id.shape[0]


class DevicePods(NamedTuple):
    valid: Tensor  # (P,) bool
    req: Tensor  # (P, R) f32
    nonzero_req: Tensor  # (P, 2) f32
    selprog_id: Tensor  # (P,) i32
    prefprog_id: Tensor  # (P,) i32
    tolset_id: Tensor  # (P,) i32
    name_req: Tensor  # (P,) i32
    priority: Tensor  # (P,) i32
    port_wild_pp: Tensor  # (P, Upp) f32
    port_spec_pp: Tensor  # (P, Upp) f32
    port_spec_pip: Tensor  # (P, Upip) f32
    image_mh: Tensor  # (P, Ui) f32
    owner_id: Tensor  # (P,) i32
    owner_uid_id: Tensor  # (P,) i32
    owner_match_mh: Tensor  # (P, Uo) f32
    order: Tensor  # (P,) i32
    matcher_mh: Tensor  # (P, M) f32
    affprog_id: Tensor  # (P,) i32
    prefaffprog_id: Tensor  # (P,) i32
    spread_hard_id: Tensor  # (P,) i32
    spread_soft_id: Tensor  # (P,) i32
    self_aff_match: Tensor  # (P,) bool
    anti_term_mh: Tensor  # (P, Ua) f32
    sym_term_mh: Tensor  # (P, Us) f32
    has_aff: Tensor  # (P,) bool
    vol_any_mh: Tensor  # (P, Uv) f32
    vol_rw_mh: Tensor  # (P, Uv) f32
    pd_mh: Tensor  # (P, Uvd) f32
    csi_mh: Tensor  # (P, Uvc) f32
    vol_error: Tensor  # (P,) bool
    limits: Tensor  # (P, 2) f32 cpu/mem limits

    @property
    def n(self) -> int:
        return self.selprog_id.shape[0]


class DeviceSelectors(NamedTuple):
    """Flattened selector programs + toleration tables. Padded rows carry
    explicit valid masks; AND/OR segment reductions use neutral fills."""

    expr_valid: Tensor  # (E,) bool
    expr_term: Tensor  # (E,) i32
    expr_op: Tensor  # (E,) i32
    expr_pairs_mh: Tensor  # (E, Up) f32
    expr_key: Tensor  # (E,) i32
    expr_lit: Tensor  # (E,) f32
    term_valid: Tensor  # (T,) bool
    term_prog: Tensor  # (T,) i32
    p_expr_valid: Tensor
    p_expr_term: Tensor
    p_expr_op: Tensor
    p_expr_pairs_mh: Tensor
    p_expr_key: Tensor
    p_expr_lit: Tensor
    p_term_valid: Tensor
    p_term_prog: Tensor
    p_term_weight: Tensor  # (Tp,) f32
    tol_hard_mh: Tensor  # (S, Ut) f32
    tol_soft_mh: Tensor  # (S, Ut) f32
    image_sizes: Tensor  # (Ui,) f32
    # program-count masks: their shapes carry the padded program counts
    prog_valid: Tensor  # (G,) bool
    p_prog_valid: Tensor  # (Gp,) bool


class DeviceVolumes(NamedTuple):
    """Volume-constraint tables: universe metadata (token kinds/escapes)
    plus this batch's VolumeZone rows and VolumeBinding CNF clauses."""

    conflict_escape: Tensor  # (Uv,) f32
    pd_type_onehot: Tensor  # (Uvd, 4) f32
    csi_driver_onehot: Tensor  # (Uvc, Dc) f32
    vz_valid: Tensor  # (Rv,) bool
    vz_pod: Tensor  # (Rv,) i32 — pad rows -> 0 with valid False
    vz_pairs_mh: Tensor  # (Rv, Up) f32
    vb_row_valid: Tensor  # (Rb,) bool
    vb_row_clause: Tensor  # (Rb,) i32
    vb_row_prog: Tensor  # (Rb,) i32
    vb_clause_valid: Tensor  # (Cb,) bool
    vb_clause_pod: Tensor  # (Cb,) i32
    vb_clause_bound: Tensor  # (Cb,) bool


_KINDS = {
    "nodes": DeviceNodes,
    "pods": DevicePods,
    "selectors": DeviceSelectors,
    "volumes": DeviceVolumes,
}


def _pad_rows(a: np.ndarray, rows: int, fill=0) -> np.ndarray:
    if a.shape[0] == rows:
        return a
    out = np.full((rows,) + a.shape[1:], fill, a.dtype)
    out[: a.shape[0]] = a
    return out


def _to(device):
    """numpy -> a fresh tensor on ``device`` (always a copy: the device
    tables are updated in place and must never alias host tables).
    Raises when ``cuda`` is asked for and no card is visible."""
    dev = resolve_device(device)
    return lambda a: torch.tensor(np.asarray(a), device=dev)


def nodes_to_device(t: NodeTable, pad_to: int | None = None,
                    device="cuda") -> DeviceNodes:
    n_pad = pad_to or bucket_size(max(t.n, 1))
    up = _to(device)
    valid = np.zeros((n_pad,), bool)
    valid[: t.n] = True
    f32 = lambda a: up(_pad_rows(a.astype(np.float32), n_pad))
    return DeviceNodes(
        valid=up(valid),
        name_id=up(_pad_rows(t.name_id, n_pad, -1)),
        allocatable=f32(t.allocatable),
        requested=f32(t.requested),
        nonzero_req=f32(t.nonzero_req),
        pair_mh=f32(t.pair_mh),
        key_mh=f32(t.key_mh),
        key_val=f32(t.key_val),
        key_num=f32(t.key_num),
        taint_hard_mh=f32(t.taint_hard_mh),
        taint_soft_mh=f32(t.taint_soft_mh),
        port_any_mh=f32(t.port_any_mh),
        port_wild_mh=f32(t.port_wild_mh),
        port_spec_mh=f32(t.port_spec_mh),
        image_mh=f32(t.image_mh),
        owner_counts=f32(t.owner_counts),
        zone_id=up(_pad_rows(t.zone_id, n_pad, -1)),
        zone_valid=up(t.zone_valid),
        avoid_mh=f32(t.avoid_mh),
        ready=up(_pad_rows(t.ready, n_pad, False)),
        network_unavailable=up(_pad_rows(t.network_unavailable, n_pad, True)),
        schedulable=up(_pad_rows(t.schedulable, n_pad, False)),
        mem_pressure=up(_pad_rows(t.mem_pressure, n_pad, True)),
        disk_pressure=up(_pad_rows(t.disk_pressure, n_pad, True)),
        pid_pressure=up(_pad_rows(t.pid_pressure, n_pad, True)),
        topo_pair_id=up(_pad_rows(t.topo_pair_id, n_pad, -1)),
        matcher_counts=f32(t.matcher_counts),
        anti_counts=f32(t.anti_counts),
        sym_counts=f32(t.sym_counts),
        aff_pod_count=f32(t.aff_pod_count),
        vol_any_mh=f32(t.vol_any_mh),
        vol_rw_mh=f32(t.vol_rw_mh),
        pd_mh=f32(t.pd_mh),
        pd_limit=up(_pad_rows(t.pd_limit.astype(np.float32), n_pad, 0.0)),
        csi_mh=f32(t.csi_mh),
        csi_limit=up(_pad_rows(t.csi_limit.astype(np.float32), n_pad,
                               np.inf)),
        has_zone_label=up(_pad_rows(t.has_zone_label, n_pad, False)),
    )


def pods_to_device(t: PodTable, pad_to: int | None = None,
                   device="cuda") -> DevicePods:
    p_pad = pad_to or bucket_size(max(t.n, 1))
    up = _to(device)
    valid = np.zeros((p_pad,), bool)
    valid[: t.n] = True
    f32 = lambda a: up(_pad_rows(a.astype(np.float32), p_pad))
    i32 = lambda a, fill=-1: up(_pad_rows(a, p_pad, fill))
    return DevicePods(
        valid=up(valid),
        req=f32(t.req),
        nonzero_req=f32(t.nonzero_req),
        selprog_id=i32(t.selprog_id),
        prefprog_id=i32(t.prefprog_id),
        tolset_id=i32(t.tolset_id),
        name_req=i32(t.name_req),
        priority=i32(t.priority, 0),
        port_wild_pp=f32(t.port_wild_pp),
        port_spec_pp=f32(t.port_spec_pp),
        port_spec_pip=f32(t.port_spec_pip),
        image_mh=f32(t.image_mh),
        owner_id=i32(t.owner_id),
        owner_uid_id=i32(t.owner_uid_id),
        owner_match_mh=f32(t.owner_match_mh),
        order=i32(t.order, -1),
        matcher_mh=f32(t.matcher_mh),
        affprog_id=i32(t.affprog_id),
        prefaffprog_id=i32(t.prefaffprog_id),
        spread_hard_id=i32(t.spread_hard_id),
        spread_soft_id=i32(t.spread_soft_id),
        self_aff_match=up(_pad_rows(t.self_aff_match, p_pad, False)),
        anti_term_mh=f32(t.anti_term_mh),
        sym_term_mh=f32(t.sym_term_mh),
        has_aff=up(_pad_rows(t.has_aff, p_pad, False)),
        vol_any_mh=f32(t.vol_any_mh),
        vol_rw_mh=f32(t.vol_rw_mh),
        pd_mh=f32(t.pd_mh),
        csi_mh=f32(t.csi_mh),
        vol_error=up(_pad_rows(t.vol_error, p_pad, False)),
        limits=f32(t.limits),
    )


#: DeviceNodes fields that are NOT (N,)-row-shaped and therefore must not
#: be row-scattered by the delta patch: ``valid`` is resident state (row
#: membership only changes on full rebuilds), ``zone_valid`` is
#: universe-shaped and is refreshed wholesale from the delta pack.
_NODE_NON_ROW_FIELDS = ("valid", "zone_valid")


def scatter_node_rows(resident: DeviceNodes, sub: DeviceNodes,
                      idx: np.ndarray) -> DeviceNodes:
    """Patch dirty rows of the resident device NodeTable IN PLACE
    (``index_copy_`` into the resident tensors — the steady-state cycle
    never reallocates or re-uploads the full table). ``idx`` (D,) host
    row indices aligned with ``sub``'s rows; entries >= the resident row
    count are padding and are dropped. The caller (SchedulerCache) is the
    sole owner of the resident tensors, which is what makes the in-place
    update safe. Returns the patched DeviceNodes (same tensors, fresh
    ``zone_valid``)."""
    idx = np.asarray(idx, np.int64)
    keep = np.nonzero(idx < resident.n)[0]
    if len(keep):
        dev = resident.valid.device
        rows = torch.from_numpy(idx[keep]).to(dev)
        src = torch.from_numpy(keep).to(dev)
        for name in DeviceNodes._fields:
            if name in _NODE_NON_ROW_FIELDS:
                continue
            getattr(resident, name).index_copy_(
                0, rows, getattr(sub, name).index_select(0, src))
    return resident._replace(zone_valid=sub.zone_valid)


def selectors_to_device(t: SelectorTables, device="cuda") -> DeviceSelectors:
    up = _to(device)

    def pack(n_e, n_t, e_term, e_op, e_pairs, e_key, e_lit, t_prog, t_w=None):
        e_pad = bucket_size(max(n_e, 1))
        t_pad = bucket_size(max(n_t, 1))
        ev = np.zeros((e_pad,), bool)
        ev[:n_e] = True
        tv = np.zeros((t_pad,), bool)
        tv[:n_t] = True
        out = dict(
            expr_valid=up(ev),
            expr_term=up(_pad_rows(e_term, e_pad, 0)),
            expr_op=up(_pad_rows(e_op, e_pad, 0)),
            expr_pairs_mh=up(_pad_rows(e_pairs.astype(np.float32), e_pad)),
            expr_key=up(_pad_rows(e_key, e_pad, -1)),
            expr_lit=up(_pad_rows(e_lit, e_pad, 0.0)),
            term_valid=up(tv),
            term_prog=up(_pad_rows(t_prog, t_pad, 0)),
        )
        if t_w is not None:
            out["term_weight"] = up(_pad_rows(t_w, t_pad, 0.0))
        return out

    r = pack(t.n_exprs, t.n_terms, t.expr_term, t.expr_op, t.expr_pairs_mh,
             t.expr_key, t.expr_lit, t.term_prog)
    p = pack(t.p_n_exprs, t.p_n_terms, t.p_expr_term, t.p_expr_op,
             t.p_expr_pairs_mh, t.p_expr_key, t.p_expr_lit, t.p_term_prog,
             t.p_term_weight)
    s_pad = bucket_size(max(t.tol_hard_mh.shape[0], 1))
    return DeviceSelectors(
        expr_valid=r["expr_valid"],
        expr_term=r["expr_term"],
        expr_op=r["expr_op"],
        expr_pairs_mh=r["expr_pairs_mh"],
        expr_key=r["expr_key"],
        expr_lit=r["expr_lit"],
        term_valid=r["term_valid"],
        term_prog=r["term_prog"],
        p_expr_valid=p["expr_valid"],
        p_expr_term=p["expr_term"],
        p_expr_op=p["expr_op"],
        p_expr_pairs_mh=p["expr_pairs_mh"],
        p_expr_key=p["expr_key"],
        p_expr_lit=p["expr_lit"],
        p_term_valid=p["term_valid"],
        p_term_prog=p["term_prog"],
        p_term_weight=p["term_weight"],
        tol_hard_mh=up(_pad_rows(t.tol_hard_mh.astype(np.float32), s_pad)),
        tol_soft_mh=up(_pad_rows(t.tol_soft_mh.astype(np.float32), s_pad)),
        image_sizes=up(t.image_sizes),
        prog_valid=up(_pad_rows(np.ones((t.n_progs,), bool),
                                bucket_size(max(t.n_progs, 1)), False)),
        p_prog_valid=up(_pad_rows(np.ones((t.p_n_progs,), bool),
                                  bucket_size(max(t.p_n_progs, 1)), False)),
    )


def volumes_to_device(t: VolumeTables, device="cuda") -> DeviceVolumes:
    from kubernetes_tpu_torch.volumes import N_PD_FILTERS

    up = _to(device)

    def onehot(idx: np.ndarray, width: int):
        oh = np.zeros((len(idx), width), np.float32)
        if len(idx):
            oh[np.arange(len(idx)), np.clip(idx, 0, width - 1)] = 1.0
        return up(oh)

    def valid(n: int, rows: int):
        v = np.zeros((rows,), bool)
        v[:n] = True
        return up(v)

    Rv = bucket_size(max(t.vz_n_rows, 1), 4)
    Rb = bucket_size(max(t.vb_n_rows, 1), 4)
    Cb = bucket_size(max(t.vb_n_clauses, 1), 4)
    Dc = bucket_size(max(t.n_csi_drivers, 1), 4)
    return DeviceVolumes(
        conflict_escape=up(t.conflict_escape),
        pd_type_onehot=onehot(t.pd_type, N_PD_FILTERS),
        csi_driver_onehot=onehot(t.csi_driver, Dc),
        vz_valid=valid(t.vz_n_rows, Rv),
        vz_pod=up(_pad_rows(t.vz_pod, Rv, 0)),
        vz_pairs_mh=up(_pad_rows(t.vz_pairs_mh.astype(np.float32), Rv)),
        vb_row_valid=valid(t.vb_n_rows, Rb),
        vb_row_clause=up(_pad_rows(t.vb_row_clause, Rb, 0)),
        vb_row_prog=up(_pad_rows(t.vb_row_prog, Rb, 0)),
        vb_clause_valid=valid(t.vb_n_clauses, Cb),
        vb_clause_pod=up(_pad_rows(t.vb_clause_pod, Cb, 0)),
        vb_clause_bound=up(_pad_rows(t.vb_clause_bound, Cb, False)),
    )


def from_numpy(kind: str, fields: dict, device="cuda"):
    """Build one of the port's containers from numpy arrays keyed by field
    name — e.g. ``{f: np.asarray(getattr(jax_nodes, f)) for f in
    DeviceNodes._fields}`` read out of the reference package's tables, so
    both packages compute on identical inputs. ``kind`` is ``nodes``,
    ``pods``, ``selectors`` or ``volumes``. Dtypes carry over as they
    are."""
    cls = _KINDS[kind]
    up = _to(device)
    return cls(**{f: up(np.asarray(fields[f])) for f in cls._fields})
