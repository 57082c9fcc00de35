"""The port's benchmark: runs one cell of ``BENCHMARK.json`` once on the
card and prints its result as the last line of standard output.

    python3 schedbench/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

A cell is ``<config>.<mix>``; ``schedbench/README.md`` says how the
files of a cell are found and how to add one. ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics. Every
run checks the placements it timed against the plain reference and
prints each number compared beside its limit, as the last lines of
standard error and under ``checks``, the result's last key.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # caches at fixed paths inside the checkout; no library loads JAX
    cache = os.path.join(ROOT, "schedbench", "_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    # one thread for the CPU libraries: the host path is one Python
    # thread, and idle pool threads only compete for the host's cores
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)

    from schedbench.core.spec import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"schedbench: {cell.name} needs {cell.chips} CUDA card(s), "
              f"this process sees {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    from schedbench.core.harness import forbidden_modules, run_cell

    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   device="cuda", t_process=T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"schedbench: modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 3
    for note in out.notes:
        print(f"schedbench: {note}")
    for name, c in out.checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out.result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
