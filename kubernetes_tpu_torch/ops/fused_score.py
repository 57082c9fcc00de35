"""The fused NodeAffinity + TaintToleration normalize pair — the masked
NormalizeReduce of both hoisted-raw priorities in one output (the two
Pallas kernels of ``kubernetes_tpu/ops/fused_score.py`` become one CUDA
kernel, ``csrc/fused_pair.cu``).

The two priorities (NodeAffinity forward, TaintToleration reverse —
priorities/reduce.go NormalizeReduce semantics over the filtered node
list, generic_scheduler.go:684) each need a masked row max and a scale
per round. The kernel reads each row once for both maxima and once more
(from L2) for the scaled, weighted sum. Per-element arithmetic
replicates ``priorities._idiv`` and ``_normalize_reduce`` exactly, and
f32 max is exact under any association, so the result is bit-identical
to :func:`fused_pair_normalize_plain`.
"""

from __future__ import annotations

import torch

from kubernetes_tpu_torch import kernels

MAX_PRIORITY = 10.0
_EPS = 1e-5


def _idiv(num, den):
    """ops/priorities._idiv verbatim (Go integer division in f32)."""
    return torch.floor(num / torch.clamp_min(den, 1e-30) + _EPS)


def fused_pair_normalize_plain(raw_fwd, raw_rev, mask, w_fwd, w_rev):
    """The plain PyTorch version of the pair kernel:
    ``w_fwd * NormalizeReduce(raw_fwd) + w_rev * NormalizeReduce_rev(raw_rev)``
    over the feasible entries of each row (masked-out entries count 0)."""
    mxf = torch.where(mask, raw_fwd, 0.0).amax(1, keepdim=True)
    sf = _idiv(MAX_PRIORITY * raw_fwd, torch.where(mxf > 0, mxf, 1.0))
    sf = torch.where(mxf > 0, sf, 0.0)
    mxr = torch.where(mask, raw_rev, 0.0).amax(1, keepdim=True)
    sr = _idiv(MAX_PRIORITY * raw_rev, torch.where(mxr > 0, mxr, 1.0))
    sr = torch.where(mxr > 0, sr, 0.0)
    sr = torch.where(mxr > 0, MAX_PRIORITY - sr, MAX_PRIORITY)
    return w_fwd * sf + w_rev * sr


def fused_pair_normalize(raw_fwd, raw_rev, mask, w_fwd, w_rev):
    """(P, N) f32 fused pair. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (or raises). On the card N must be a
    multiple of four."""
    if raw_fwd.device.type == "cpu":
        return fused_pair_normalize_plain(raw_fwd, raw_rev, mask, w_fwd,
                                          w_rev)
    P, N = raw_fwd.shape
    kernels.require(raw_fwd, "fused_pair_normalize raw_fwd", torch.float32)
    kernels.require(raw_rev, "fused_pair_normalize raw_rev", torch.float32,
                    (P, N))
    kernels.require(mask, "fused_pair_normalize mask", torch.bool, (P, N))
    out = torch.empty((P, N), dtype=torch.float32, device=raw_fwd.device)
    kernels.require_vec4(N, "fused_pair_normalize", raw_fwd, raw_rev, mask,
                         out)
    fn = kernels.lib("fused_pair").ktt_fused_pair_normalize
    code = fn(raw_fwd.data_ptr(), raw_rev.data_ptr(), mask.data_ptr(),
              out.data_ptr(), P, N, float(w_fwd), float(w_rev),
              kernels.stream_ptr(raw_fwd))
    kernels.check(code, "fused_pair_normalize")
    kernels.LAUNCHES["fused_pair_normalize"] += 1
    return out
