"""Sinkhorn optimal-transport scoring for batched assignment (the port of
``kubernetes_tpu/ops/sinkhorn.py``).

The round solver's per-pod argmax is myopic: every pod bids its best node
regardless of global contention. The entropic-OT plan instead balances the
whole batch against node capacities, so pods whose best nodes tie on
scarce capacity but whose second choices differ are spread by opportunity
cost (pinned by tests/test_torch_sinkhorn.py, the port of
``test_plan_beats_argmax_on_tied_preferences``).

Formulation: unbalanced entropic OT with
  - row marginals: each schedulable pod ships (at most) mass 1,
  - column marginals: node j receives AT MOST ``capacity_j`` (the column
    scaling only ever scales down),
  - kernel K = exp(score/eps) on feasible (pod, node) pairs.

Iterations run in log space. Each iteration is one row pass
(:func:`sinkhorn_u`) and one column pass (:func:`sinkhorn_v`); on a CUDA
tensor each is a hand-written kernel (``csrc/sinkhorn.cu``), on a CPU
tensor its plain PyTorch version beside it. Each pass takes one of two
rules, as the reference does: the fixed-iteration scaling follows its
Pallas kernels (max shift clamped at NEG_INF, ``+1e-30`` inside the log,
u <= NEG_INF/2 -> NEG_INF, v <= NEG_INF/2 -> 0); the tolerance-gated loop
follows its jnp scaling, which the reference runs on every backend
(``jax.scipy.special.logsumexp``, a non-finite u -> NEG_INF, a non-finite
v -> 0, so a zero-capacity column keeps v ~ NEG_INF and takes no mass).
The kernels sum in another order than the plain versions, so the two
agree to a few ulps: the tests hold potentials and plans to
``atol=1e-5, rtol=1e-4``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from kubernetes_tpu_torch import kernels
from kubernetes_tpu_torch.ops.sync import to_host

NEG_INF = -1e30

#: convergence tolerance for the telemetry loop: max |u - u_prev| under
#: this counts the iteration as converged (log-domain, so ~relative)
STATS_TOL = 1e-3

#: the v pass: a block covers a strip of V_COLS columns (32 threads x 4)
#: and one chunk of the rows; the chunks are sized so that the grid is
#: V_BLOCKS_PER_SM blocks for each SM (one wave: the kernel's launch
#: bounds let four stay resident), with at most V_CHUNKS chunks and at
#: least V_MIN_ROWS rows (one 8-row tile per warp) in each. The last block
#: of a strip merges the strip's chunk partials. Two blocks an SM measured
#: faster than one, four or more on an H100 (scripts/torch_kernel_sweep.py:
#: longer row walks per warp, fewer partials to merge).
V_COLS = 128
V_BLOCKS_PER_SM = 2
V_CHUNKS = 64
V_MIN_ROWS = 64


def v_plan(P: int, N: int, sms: int) -> Tuple[int, int, int]:
    """(strips, chunks, rows per chunk) of the v pass on a card with
    ``sms`` SMs; every chunk holds at least one row."""
    strips = -(-N // V_COLS)
    chunks = max(1, min(V_BLOCKS_PER_SM * sms // strips, V_CHUNKS,
                        -(-P // V_MIN_ROWS)))
    rows = max(-(-P // chunks), 1)
    return strips, max(-(-P // rows), 1), rows


def _lse(x, dim: int, jnp_rule: bool):
    """Log-sum-exp of ``x`` along ``dim`` in the pass's rule: the jnp rule
    is ``jax.scipy.special.logsumexp`` (shift by the max, 0 when it is not
    finite); the Pallas rule clamps the shift at NEG_INF and adds
    ``1e-30`` inside the log."""
    m = x.amax(dim, keepdim=True)
    if jnp_rule:
        m = torch.where(torch.isfinite(m), m, 0.0)
        return (torch.log(torch.exp(x - m).sum(dim, keepdim=True))
                + m).squeeze(dim)
    m = m.clamp_min(NEG_INF)
    return (torch.log(torch.exp(x - m).sum(dim, keepdim=True) + 1e-30)
            + m).squeeze(dim)


def sinkhorn_u_plain(logk, v, log_r, jnp_rule: bool = False):
    """Row pass: ``u = log_r - lse_j(logk + v)`` (plain version)."""
    u = log_r - _lse(logk + v[None, :], 1, jnp_rule)
    if jnp_rule:
        return torch.where(torch.isfinite(u), u, NEG_INF)
    return torch.where(u > NEG_INF / 2, u, NEG_INF)


def sinkhorn_v_plain(logk, u, log_c, jnp_rule: bool = False):
    """Column pass: ``v = min(log_c - lse_i(logk + u), 0)`` (plain)."""
    v = torch.clamp_max(log_c - _lse(logk + u[:, None], 0, jnp_rule), 0.0)
    if jnp_rule:
        return torch.where(torch.isfinite(v), v, 0.0)
    return torch.where(v > NEG_INF / 2, v, 0.0)


def sinkhorn_u(logk, v, log_r, jnp_rule: bool = False):
    """(P,) row potentials in the Pallas rule, or the jnp rule with
    ``jnp_rule``. CPU tensors take the plain version; CUDA tensors launch
    the kernel (or raise; N must be a multiple of four)."""
    if logk.device.type == "cpu":
        return sinkhorn_u_plain(logk, v, log_r, jnp_rule)
    P, N = logk.shape
    kernels.require(logk, "sinkhorn_u logk", torch.float32)
    kernels.require(v, "sinkhorn_u v", torch.float32, (N,))
    kernels.require(log_r, "sinkhorn_u log_r", torch.float32, (P,))
    kernels.require_vec4(N, "sinkhorn_u", logk, v)
    u = torch.empty((P,), dtype=torch.float32, device=logk.device)
    fn = kernels.lib("sinkhorn").ktt_sinkhorn_u
    code = fn(logk.data_ptr(), v.data_ptr(), log_r.data_ptr(), u.data_ptr(),
              P, N, int(jnp_rule), kernels.stream_ptr(logk))
    kernels.check(code, "sinkhorn_u")
    kernels.count_launch("sinkhorn_u", (P, N))
    return u


def sinkhorn_v(logk, u, log_c, jnp_rule: bool = False):
    """(N,) column potentials in the Pallas rule, or the jnp rule with
    ``jnp_rule``. CPU tensors take the plain version; CUDA tensors launch
    the kernel (or raise; any N)."""
    if logk.device.type == "cpu":
        return sinkhorn_v_plain(logk, u, log_c, jnp_rule)
    P, N = logk.shape
    kernels.require(logk, "sinkhorn_v logk", torch.float32)
    kernels.require(u, "sinkhorn_v u", torch.float32, (P,))
    kernels.require(log_c, "sinkhorn_v log_c", torch.float32, (N,))
    _, chunks, rows = v_plan(P, N, kernels.sm_count(logk))
    v = launch_v(logk, u, log_c, chunks, rows, jnp_rule)
    kernels.count_launch("sinkhorn_v", (P, N))
    return v


def launch_v(logk, u, log_c, chunks: int, rows: int,
             jnp_rule: bool = False):
    """Launch the v kernel with ``chunks`` chunks of ``rows`` rows (every
    chunk at least one row) in the Pallas or the jnp rule and return v
    (no checks and no count:
    :func:`sinkhorn_v` makes both; the one place the C entry point is
    called)."""
    P, N = logk.shape
    strips = -(-N // V_COLS)
    v = torch.empty((N,), dtype=torch.float32, device=logk.device)
    # one scratch allocation: the chunk partials pm and ps, (chunks,
    # strips * V_COLS) f32 each, then one int32 counter per strip (4-byte
    # words; the entry point zeroes the counters on the stream)
    part = chunks * strips * V_COLS
    scratch = torch.empty((2 * part + strips,), dtype=torch.float32,
                          device=logk.device)
    base = scratch.data_ptr()
    fn = kernels.lib("sinkhorn").ktt_sinkhorn_v
    code = fn(logk.data_ptr(), u.data_ptr(), log_c.data_ptr(), v.data_ptr(),
              base, base + 4 * part, base + 8 * part, P, N, chunks, rows,
              int(jnp_rule), kernels.stream_ptr(logk))
    kernels.check(code, "sinkhorn_v")
    return v


def _step(logk, log_r, log_c, u, v, jnp_rule=False):
    u = sinkhorn_u(logk, v, log_r, jnp_rule)
    v = sinkhorn_v(logk, u, log_c, jnp_rule)
    return u, v


def _delta(u2, u):
    finite = (u2 > NEG_INF / 2) & (u > NEG_INF / 2)
    return torch.where(finite, (u2 - u).abs(), 0.0).amax()


def _stats_scan(logk, log_r, log_c, u, v, iters, tol=STATS_TOL):
    """``iters`` scaling iterations while tracking convergence, all on
    device: returns (u, v, stats) with stats = [first iteration whose max
    row-potential delta dropped under ``tol`` (``iters`` if never), final
    delta]."""
    conv = torch.full((), -1, dtype=torch.int32, device=logk.device)
    delta = torch.zeros((), dtype=torch.float32, device=logk.device)
    for i in range(iters):
        u2, v2 = _step(logk, log_r, log_c, u, v)
        delta = _delta(u2, u)
        conv = torch.where((conv < 0) & (delta < tol),
                           torch.full_like(conv, i + 1), conv)
        u, v = u2, v2
    used = torch.where(conv < 0, torch.full_like(conv, iters), conv)
    return u, v, torch.stack([used.to(torch.float32), delta])


def _tol_scan(logk, log_r, log_c, u, v, iters, tol):
    """Tolerance-gated scaling loop: iterate until the max row-potential
    delta drops under ``tol`` or the ``iters`` budget runs out. Its passes
    take the jnp rule, as the reference's loop (``_scale_jnp``) does on
    every backend. The loop condition is read on the host, one counted
    sync per iteration."""
    i = 0
    delta = float("inf")
    while i < iters and delta >= tol:
        u2, v2 = _step(logk, log_r, log_c, u, v, jnp_rule=True)
        delta = to_host(_delta(u2, u))
        u, v = u2, v2
        i += 1
    import numpy as np

    from kubernetes_tpu_torch.ops.arrays import upload

    stats = upload([float(i), delta], logk.device, np.float32)
    return u, v, stats


def _scale(logk, log_r, log_c, iters, with_stats=False, u0=None, v0=None,
           tol=None):
    """Alternating log-domain scaling, columns capped at 0 (inequality).
    Returns (u, v, stats) — stats is None unless ``with_stats`` or ``tol``
    is set. ``u0``/``v0`` warm-start the potentials (scaling converges
    from any start, so a warm start changes only the iteration count);
    ``tol`` switches to the tolerance-gated loop (:func:`_tol_scan`)."""
    P, N = logk.shape
    u = (torch.zeros((P,), dtype=torch.float32, device=logk.device)
         if u0 is None else u0)
    v = (torch.zeros((N,), dtype=torch.float32, device=logk.device)
         if v0 is None else v0)
    if tol is not None:
        return _tol_scan(logk, log_r, log_c, u, v, iters, tol)
    if with_stats:
        return _stats_scan(logk, log_r, log_c, u, v, iters)
    for _ in range(iters):
        u, v = _step(logk, log_r, log_c, u, v)
    return u, v, None


def sinkhorn_plan(
    score: torch.Tensor,
    mask: torch.Tensor,
    capacity: torch.Tensor,
    eps: float = 0.5,
    iters: int = 25,
    with_stats: bool = False,
    init: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    tol: Optional[float] = None,
    return_potentials: bool = False,
):
    """Transport plan (P, N): plan[p, j] ≈ how much of pod p's unit demand
    node j serves at equilibrium. Row sums <= 1; column sums <= capacity
    + O(tolerance).

    ``with_stats`` additionally returns a (2,) f32 device tensor
    [iterations-to-converge, final max row-potential delta]. ``init`` is a
    ``(u0, v0)`` warm start (scaling converges from any start to the same
    fixpoint); ``tol`` switches to the tolerance-gated loop;
    ``return_potentials`` appends the final ``(u, v)``."""
    score = score.to(torch.float32)
    row_ok = mask.any(1)
    logk = torch.where(mask, score / eps, NEG_INF).contiguous()
    log_r = torch.where(row_ok, 0.0, NEG_INF)
    log_c = torch.where(capacity > 0,
                        torch.log(torch.clamp_min(capacity, 1e-30)), NEG_INF)
    log_c = log_c.to(torch.float32)
    u0 = v0 = None
    if init is not None:
        # sanitize a foreign start: non-finite rows restart from zero (a
        # NEG_INF row potential would wedge its row at zero mass)
        u0, v0 = init
        u0 = torch.where(torch.isfinite(u0) & (u0 > NEG_INF / 2), u0,
                         0.0).to(torch.float32).contiguous()
        v0 = torch.where(torch.isfinite(v0) & (v0 > NEG_INF / 2), v0,
                         0.0).to(torch.float32).contiguous()
    u, v, stats = _scale(logk, log_r, log_c, iters, with_stats=with_stats,
                         u0=u0, v0=v0, tol=tol)
    plan = torch.exp(torch.clamp(logk + u[:, None] + v[None, :], NEG_INF,
                                 30.0))
    plan = torch.where(mask, plan, 0.0)
    out = (plan,)
    if with_stats:
        out = out + (stats,)
    if return_potentials:
        out = out + ((u, v),)
    return out if len(out) > 1 else plan
