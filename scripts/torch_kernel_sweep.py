"""Times the port's kernel wrappers by every method ``chip_smoke.py`` uses,
for this checkout or another one, with the card's own byte-rate
yardsticks and the v pass's launch-plan sweep beside them.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 scripts/torch_kernel_sweep.py [--root DIR]
        [--shapes 8192x8192,4096x8192] [--parts wrappers,yardsticks,chunks]

``--root`` imports ``kubernetes_tpu_torch`` from another checkout (for
example an unpacked ``git archive`` of the parent commit), so two trees'
kernels are timed by the same code in one call; the timing helpers and
the inputs always come from this checkout's ``chip_smoke.py``. Parts:

- ``wrappers``: ``fused_pair_normalize``, ``sinkhorn_u`` and
  ``sinkhorn_v`` at each shape, each held against its plain version on
  the same inputs (the pair bit for bit, the Sinkhorn passes within atol
  1e-5 / rtol 1e-4), then timed: ``ms`` (single-call CUDA-event median),
  ``ms_batched`` (10 back-to-back calls), ``device_ms`` (torch.profiler's
  device time) and ``host_ms`` (the wrapper's own host time, median);
- ``yardsticks``: what the card's HBM delivers to one PyTorch call on
  the same (P, N) f32 tensor: ``torch.sum`` (one read) and ``clone``
  (one read, one write);
- ``chunks``: the v kernel launched through ``sinkhorn.launch_v`` at
  several chunk counts, the launch plan's one free parameter, each output
  held against the plain version (this checkout's package only);
- ``split``: the split u pass (``sinkhorn_u_partial``) on one shard's
  (P, N / d) block of each shape, d in 2, 4, 8, held against its plain
  version in both rules, then its device time warm (``device_ms``), with
  the L2 cold (``chip_smoke.cold_ms``: a 64 MB scratch overwritten, then
  96 MB read, before each launch) and after the overwrite alone
  (``cold_dirty_ms``: the L2 left full of dirty lines, whose write-back
  the kernel's misses pay).

One JSON object per line; the card's name and power limit come first.
It needs a CUDA card and exits non-zero without one or on a mismatch.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def host_ms(fn, reps: int = 20) -> float:
    """Median host milliseconds of one ``fn()`` (until it returns; the
    card drained between calls)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
        torch.cuda.synchronize()
    return statistics.median(times) * 1e3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose kubernetes_tpu_torch is timed")
    ap.add_argument("--shapes", default="8192x8192,4096x8192")
    ap.add_argument("--parts", default="wrappers,yardsticks,chunks")
    ap.add_argument("--chunks", default="2,4,8,16,32,64")
    args = ap.parse_args()
    parts = set(args.parts.split(","))

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_kernel_sweep: needs a CUDA card")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import kubernetes_tpu_torch
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.ops import fused_score, sinkhorn

    emit({"nvidia_smi": cs.gpu_line(),
          "device": torch.cuda.get_device_name(0),
          "package": os.path.dirname(kubernetes_tpu_torch.__file__),
          "sms": torch.cuda.get_device_properties(0).multi_processor_count})
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261019)
    for shape in args.shapes.split(","):
        P, N = (int(x) for x in shape.split("x"))
        if "wrappers" in parts:
            rf, rr, mask = cs._pair_inputs(P, N, gen, dev)
            logk, log_r, log_c, u, v = cs._sinkhorn_inputs(P, N, gen, dev)
            for name, kern, plain, exact in (
                    ("fused_pair_normalize",
                     lambda: fused_score.fused_pair_normalize(
                         rf, rr, mask, 1.0, 1.0),
                     lambda: fused_score.fused_pair_normalize_plain(
                         rf, rr, mask, 1.0, 1.0), True),
                    ("sinkhorn_u", lambda: sinkhorn.sinkhorn_u(logk, v, log_r),
                     lambda: sinkhorn.sinkhorn_u_plain(logk, v, log_r),
                     False),
                    ("sinkhorn_v", lambda: sinkhorn.sinkhorn_v(logk, u, log_c),
                     lambda: sinkhorn.sinkhorn_v_plain(logk, u, log_c),
                     False)):
                got, want = kern(), plain()
                torch.cuda.synchronize()
                ok = (torch.equal(got, want) if exact else torch.allclose(
                    got, want, atol=cs.SINKHORN_ATOL, rtol=cs.SINKHORN_RTOL))
                if not ok:
                    sys.exit(f"{name} {P}x{N} disagrees with its plain "
                             "version")
                emit({"shape": [P, N], "wrapper": name,
                      "max_abs_err": float((got - want).abs().max()),
                      "ms": cs.cuda_time_ms(kern),
                      "ms_batched": cs.batched_ms(kern),
                      "device_ms": cs.device_ms(kern),
                      "host_ms": host_ms(kern)})
            del rf, rr, mask, logk, log_r, log_c, u, v, got, want
            torch.cuda.empty_cache()
        if "yardsticks" in parts:
            x = torch.rand((P, N), generator=gen, device=dev)
            nbytes = P * N * 4
            for name, call, moved in (
                    ("torch.sum", lambda: torch.sum(x), nbytes),
                    ("clone", lambda: x.clone(), 2 * nbytes)):
                ms = cs.batched_ms(call)
                emit({"shape": [P, N], "yardstick": name, "ms_batched": ms,
                      "device_ms": cs.device_ms(call), "bytes": moved,
                      "gb_per_s": moved / ms / 1e6})
            del x
        if "chunks" in parts:
            if not hasattr(sinkhorn, "launch_v"):
                sys.exit(f"{root}: no sinkhorn.launch_v to sweep")
            logk, _log_r, log_c, u, _v = cs._sinkhorn_inputs(P, N, gen, dev)
            want = sinkhorn.sinkhorn_v_plain(logk, u, log_c)
            for chunks in (int(c) for c in args.chunks.split(",")):
                rows = -(-P // chunks)
                chunks = -(-P // rows)

                def call():
                    return sinkhorn.launch_v(logk, u, log_c, chunks, rows)

                got = call()
                torch.cuda.synchronize()
                if not torch.allclose(got, want, atol=cs.SINKHORN_ATOL,
                                      rtol=cs.SINKHORN_RTOL):
                    sys.exit(f"sinkhorn_v {P}x{N} at {chunks} chunks "
                             "disagrees")
                emit({"shape": [P, N], "v_chunks": chunks, "rows": rows,
                      "blocks": -(-N // sinkhorn.V_COLS) * chunks,
                      "max_abs_err": float((got - want).abs().max()),
                      "ms_batched": cs.batched_ms(call),
                      "device_ms": cs.device_ms(call)})
            emit({"shape": [P, N], "v_wrapper_plan": sinkhorn.v_plan(
                P, N, kernels.sm_count(logk))})
            del logk, log_c, u, want
        if "split" in parts:
            split_widths(cs, sinkhorn, P, N, gen, dev)
        torch.cuda.empty_cache()


def split_widths(cs, sinkhorn, P, N, gen, dev) -> None:
    """The ``split`` part at one (P, N) shape (see the module's note)."""
    import torch

    logk, _log_r, _log_c, _u, v = cs._sinkhorn_inputs(P, N, gen, dev)
    scratch = torch.empty(cs.FLUSH_WRITE_BYTES // 4, device=dev)
    kernel = cs.TRACE_NAMES["sinkhorn_u_partial"]
    for d in (2, 4, 8):
        n = N // d
        lk, vb = logk[:, :n].contiguous(), v[:n].contiguous()
        for rule in (False, True):
            if not cs._u_partial_agrees(
                    sinkhorn.sinkhorn_u_partial(lk, vb, rule),
                    sinkhorn.sinkhorn_u_partial_plain(lk, vb, rule)):
                sys.exit(f"sinkhorn_u_partial {P}x{n} disagrees with its "
                         "plain version")

        def kern():
            return sinkhorn.sinkhorn_u_partial(lk, vb)

        def dirty():
            scratch.fill_(1.0)
            kern()

        by = cs.device_ms(dirty)["by_kernel"]
        hits = [t for k, t in by.items() if k.startswith(kernel)]
        emit({"shape": [P, n], "split": "sinkhorn_u_partial", "d": d,
              "device_ms": cs.device_ms(kern),
              "cold_ms": cs.cold_ms(kern, kernel),
              "cold_dirty_ms": hits[0]["ms"] if hits else None,
              **cs._split_bound("sinkhorn_u_partial", P, n)})
        del lk, vb
    del logk, v, scratch


if __name__ == "__main__":
    main()
