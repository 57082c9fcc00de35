"""The fused NodeAffinity + TaintToleration normalize pair — the masked
NormalizeReduce of both hoisted-raw priorities in one output (the two
Pallas kernels of ``kubernetes_tpu/ops/fused_score.py`` become one CUDA
kernel, ``csrc/fused_pair.cu``).

The two priorities (NodeAffinity forward, TaintToleration reverse —
priorities/reduce.go NormalizeReduce semantics over the filtered node
list, generic_scheduler.go:684) each need a masked row max and a scale
per round. A row of ``N <= STAGED_MAX_N`` with ``N % 16 == 0`` takes
the staged path: its block copies the row into shared memory once and
reads both maxima and the scaled, weighted sum from there. Other rows
take the wide path, which reads the row twice from global memory (the
second time mostly from L2). Per-element arithmetic
replicates ``priorities._idiv`` and ``_normalize_reduce`` exactly, and
f32 max is exact under any association, so the result is bit-identical
to :func:`fused_pair_normalize_plain`.
"""

from __future__ import annotations

import torch

from kubernetes_tpu_torch import kernels

MAX_PRIORITY = 10.0
_EPS = 1e-5

#: widest row the staged path holds in shared memory (9 bytes an element:
#: two at most of these 108 KB stages fit on an SM)
STAGED_MAX_N = 12288


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


def staged_route(n, *ts) -> bool:
    """Whether a row of ``n`` goes down the staged path: it fits in shared
    memory, and each row of the mask (``n`` bytes) and of the f32
    operands is a whole number of 16-byte bulk copies at a 16-byte
    aligned address (``ts``: the tensors whose rows are copied or
    stored)."""
    return (n % 16 == 0 and n <= STAGED_MAX_N
            and all(t.data_ptr() % 16 == 0 for t in ts))


def fused_pair_normalize(raw_fwd, raw_rev, mask, w_fwd, w_rev):
    """(P, N) f32 fused pair. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (or raises): the staged path where
    :func:`staged_route` allows it, else the wide path. On the card N
    must be a multiple of four."""
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
    staged = staged_route(N, raw_fwd, raw_rev, mask, out)
    launch(raw_fwd, raw_rev, mask, out, w_fwd, w_rev, staged)
    kernels.count_launch("fused_pair_normalize", (P, N))
    if not staged:
        kernels.count_launch("fused_pair_normalize_wide", (P, N))
    return out


def launch(raw_fwd, raw_rev, mask, out, w_fwd, w_rev, staged: bool):
    """Launch one path of the pair kernel into ``out`` (no checks and no
    count: :func:`fused_pair_normalize` makes both; the one place the C
    entry points are called)."""
    P, N = raw_fwd.shape
    lib = kernels.lib("fused_pair")
    fn = (lib.ktt_fused_pair_normalize if staged
          else lib.ktt_fused_pair_normalize_wide)
    code = fn(raw_fwd.data_ptr(), raw_rev.data_ptr(), mask.data_ptr(),
              out.data_ptr(), P, N, float(w_fwd), float(w_rev),
              kernels.stream_ptr(raw_fwd))
    kernels.check(code, "fused_pair_normalize")
