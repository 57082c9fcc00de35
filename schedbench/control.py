"""Reads the correctness check's controls: the plain reference put in the
program's place with one or both of the pair's priorities (NodeAffinity,
TaintToleration) left out of its scoring, the step a later change that
skipped either half of the pair, or the whole pair, would take. Prints,
for each control and seed, every number the check compares, at the
cell's own size and load; a limit lies between the program's sound runs
and the smallest of these readings (``PERF.md``).

    python3 schedbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 10 [--drop pair,node-affinity,taint-toleration]
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODE_AFFINITY = "NodeAffinityPriority"
TAINT_TOLERATION = "TaintTolerationPriority"
DROPS = {"pair": (NODE_AFFINITY, TAINT_TOLERATION),
         "node-affinity": (NODE_AFFINITY,),
         "taint-toleration": (TAINT_TOLERATION,)}


def drops_for(mix: dict):
    """The controls that change a cell's scoring: without preferred
    zones NodeAffinity scores every node alike, and dropping it alone
    changes nothing."""
    return [d for d in DROPS
            if d != "node-affinity" or "preferred_zone" in mix]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--drop", default="",
                    help="controls, comma-separated (default: every "
                         "control that changes the cell's scoring)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from schedbench.core.harness import Control, run_cell
    from schedbench.core.spec import load_cell

    cell = load_cell(args.workload)
    drops = args.drop.split(",") if args.drop else drops_for(cell.mix)
    for drop in drops:
        for seed in [int(s) for s in args.seeds.split(",")]:
            cell = load_cell(args.workload)
            out = run_cell(cell, seed, args.seconds, False, device="cpu",
                           system_factory=lambda c, n, p: Control(
                               c, n, p, DROPS[drop]))
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "control": "drop " + "+".join(DROPS[drop]),
                              "correct": out.result["correct"],
                              "judged": out.result["attempted"],
                              "numbers": {k: v["value"]
                                          for k, v in out.checks.items()}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
