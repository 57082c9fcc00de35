"""Host time of one preemptor's ``preempt()`` against the cluster size,
for the JAX package (``kubernetes_tpu/preemption.py``) and the PyTorch
port (``kubernetes_tpu_torch/preemption.py``).

The cluster: N nodes of 4 CPU, each holding four 900m pods of priority
0; one 3000m preemptor of priority 1000; every node a candidate
(``PodFitsResources``). The reference's what-if re-evaluates inter-pod
affinity and spread over the whole cluster per check, so its time grows
as nodes x pods; the port takes its node-local path here. Each
measurement runs in its own process, cut at ``--timeout`` seconds, and
prints one JSON line: package, nodes, seconds (or null when cut), the
chosen node and the victims. Both packages must choose the same.

    JAX_PLATFORMS=cpu python tests/torch_preempt_scaling.py \\
        --nodes 200,500,5000 --timeout 100

All times are host CPU times of the machine that runs the script.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(package: str, n_nodes: int) -> dict:
    """Build the cluster with ``package``'s types and time one preempt()."""
    sys.path.insert(0, REPO)
    if package == "jax":
        from kubernetes_tpu.ops.predicates import BIT
        from kubernetes_tpu.preemption import preempt
        from kubernetes_tpu.testing import make_node, make_pod
    else:
        from kubernetes_tpu_torch.ops.predicates import BIT
        from kubernetes_tpu_torch.preemption import preempt
        from kubernetes_tpu_torch.testing import make_node, make_pod
    nodes = [make_node(f"n{i}", cpu_milli=4000, pods=110)
             for i in range(n_nodes)]
    pods_of = {nd.name: [make_pod(f"{nd.name}-{k}", cpu_milli=900,
                                  node_name=nd.name) for k in range(4)]
               for nd in nodes}
    pod = make_pod("preemptor", cpu_milli=3000, priority=1000)
    bits = {nd.name: 1 << BIT["PodFitsResources"] for nd in nodes}
    t0 = time.perf_counter()
    r = preempt(pod, nodes, pods_of, bits)
    seconds = time.perf_counter() - t0
    return {"package": package, "nodes": n_nodes, "seconds": seconds,
            "node": r.node_name if r else None,
            "victims": [v.name for v in r.victims] if r else None}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", default="200,500,5000")
    ap.add_argument("--timeout", type=float, default=100.0)
    ap.add_argument("--one", nargs=2, metavar=("PACKAGE", "NODES"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.one[0], int(args.one[1]))), flush=True)
        return
    for n in (int(x) for x in args.nodes.split(",")):
        got = {}
        for package in ("jax", "torch"):
            cmd = [sys.executable, os.path.abspath(__file__), "--one",
                   package, str(n)]
            try:
                out = subprocess.run(cmd, capture_output=True, text=True,
                                     timeout=args.timeout, check=True)
                got[package] = json.loads(out.stdout.strip().splitlines()[-1])
            except subprocess.TimeoutExpired:
                got[package] = {"package": package, "nodes": n,
                                "seconds": None, "cut_at_s": args.timeout}
            print(json.dumps(got[package]), flush=True)
        if all(g["seconds"] is not None for g in got.values()):
            pick = {(g["node"], tuple(g["victims"])) for g in got.values()}
            if len(pick) != 1:
                sys.exit(f"the packages chose differently at {n} nodes: "
                         f"{got}")


if __name__ == "__main__":
    main()
