"""Analytical collective-cost model for the node-sharded solve (a copy of
``kubernetes_tpu/parallel/costmodel.py``, which imports no JAX; the port
keeps its own so that it imports nothing of the JAX package) —
bounding BASELINE config 5's scale-out claim without multi-chip hardware
(VERDICT r4 item 6).

The sharded design (parallel/mesh.py): the node axis is split N/D per
device, pods replicated. The structural property that makes scale-out
cheap — and the claim this model quantifies so the first real multi-chip
run can FALSIFY it — is that **no (P, N) matrix ever crosses ICI**.
Every cross-shard exchange in a round is a per-pod vector or a per-pod
per-zone panel:

  =====================  =========================  ==================
  round phase            collective (GSPMD-inserted) payload shape
  =====================  =========================  ==================
  filter                 all-reduce OR               (P,) bool
  score: NA normalize    all-reduce MAX              (P,) f32
  score: TT normalize    all-reduce MAX              (P,) f32
  score: spread max      all-reduce MAX              (P,) f32
  score: spread zones    psum + zone-present         2 x (P, Z) f32
  score: interpod mx/mn  all-reduce MAX/MIN          2 x (P,) f32
  score: evenspread      psum total + MIN            2 x (P,) f32
  bid: rowmax            all-reduce MAX              (P,) f32
  bid: feasible_any      all-reduce OR               (P,) bool
  tie cumsum offsets     all-gather shard sums       (P,) i16 x D terms
  pick: choice argmax    all-reduce ARGMAX           (P,) f32+i32
  router (round 0 only)  2 all-reduces               (P,) f32
  acceptance: free rows  worst-case all-gather       (N, R) f32
  =====================  =========================  ==================

Usage scatters land on the owning shard locally (pods are replicated, so
each device applies the accepted subset to its own node rows) — zero
collective cost.

Cost model: ring all-reduce/all-gather moves ``2 (D-1)/D x bytes``
across the slowest link; each collective also pays a latency floor.
The v5e ICI envelope is parameterized (default 1e11 B/s per chip
aggregate with a 45 GB/s conservative floor — the public "How to Scale
Your Model" v5e numbers bracket this range) precisely so the prediction
is a RANGE the hardware run can land inside or break.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

#: ring-collective traffic factor for D devices
_RING = lambda d: 2.0 * (d - 1) / max(d, 1)


@dataclass
class CollectiveCostModel:
    devices: int
    pods_per_batch: int          # P (padded batch)
    nodes_padded: int            # N (padded node axis)
    zones: int = 16
    resources: int = 8           # R columns in the usage/free tables
    rounds_per_batch: int = 2    # measured: config5 runs resolve in 2
    ici_bytes_per_s_low: float = 4.5e10    # conservative v5e per-chip
    ici_bytes_per_s_high: float = 2.0e11   # optimistic aggregate
    collective_latency_s: float = 5e-6     # per-collective floor
    #: single-device steady throughput anchors (pods/s at this shape)
    single_device_cpu_pods_per_s: float = 144.0  # config5_cpu_mesh_r04

    def per_round_collectives(self) -> dict:
        """Enumerated payloads (bytes, pre-ring-factor) per round."""
        P, Z, N, R, D = (self.pods_per_batch, self.zones,
                         self.nodes_padded, self.resources, self.devices)
        f32, i16, b1 = 4, 2, 1
        items = {
            "filter_feasible_any_bool": P * b1,
            "score_normalize_maxes_x3": 3 * P * f32,
            "score_zone_panels_x2": 2 * P * Z * f32,
            "score_topology_reduces_x4": 4 * P * f32,
            "bid_rowmax": P * f32,
            "bid_feasible_any_bool": P * b1,
            "tie_cumsum_shard_sums": P * i16 * D,
            "pick_argmax_value_index": P * (f32 + 4),
            "acceptance_free_rows_allgather_worstcase": N * R * f32,
            # round-0 router all-reduces, amortized over the batch's
            # rounds so per-round figures stay honest multipliers
            "router_round0_amortized": int(
                2 * P * f32 / max(self.rounds_per_batch, 1)),
        }
        items["total_bytes"] = sum(items.values())
        # one collective per table row: 1 filter + 3 maxes + 2 zone
        # panels + 4 topology + rowmax + feasible_any + cumsum + argmax
        # + free-rows gather = 15, plus 2/rounds router amortized
        items["n_collectives"] = 15 + 2 / max(self.rounds_per_batch, 1)
        return items

    def predict(self) -> dict:
        d = self.devices
        per_round = self.per_round_collectives()
        wire = per_round["total_bytes"] * _RING(d)
        lat = per_round["n_collectives"] * self.collective_latency_s
        t_coll_low = wire / self.ici_bytes_per_s_low + lat
        t_coll_high = wire / self.ici_bytes_per_s_high + lat
        # per-device compute: node-axis work divides linearly (every
        # (P, N) kernel tiles along the shard); the CPU anchor gives a
        # hardware-independent LOWER bound on throughput
        t_round_cpu_1dev = (self.pods_per_batch
                            / self.single_device_cpu_pods_per_s
                            / self.rounds_per_batch)
        t_round_cpu_ddev = t_round_cpu_1dev / d
        eff_low = t_round_cpu_ddev / (t_round_cpu_ddev + t_coll_low)
        tput_cpu_basis = (self.single_device_cpu_pods_per_s * d * eff_low)
        return {
            "devices": d,
            "per_round_collective_bytes_on_wire": int(wire),
            "per_round_collective_time_s": [round(t_coll_high, 7),
                                            round(t_coll_low, 7)],
            "per_round_compute_s_cpu_anchor_per_device":
                round(t_round_cpu_ddev, 4),
            "scaleout_efficiency_cpu_anchor": round(eff_low, 5),
            "predicted_pods_per_s_cpu_anchor": round(tput_cpu_basis, 1),
            "tpu_prediction": (
                "pods_per_s(v5e-8) = 8 x S x eff. S was MEASURED this "
                "round: 7270 pods/s single-chip at 50k nodes x 4096 "
                "batch (benchres/bench_tpu_r05_full.json "
                "config5_sharded_50k) => predicted ~58k pods/s on a "
                "v5e-8 at eff 0.9999; per-round compute ~0.28 s vs "
                "collectives 0.1-0.2 ms keeps collectives <0.1% of a "
                "round — the falsifiable claims are eff >= 0.99 and NO "
                "(P,N)-sized ICI transfer in the profiled HLO"
            ),
        }

    def document(self) -> dict:
        return {
            "what": ("Analytical ICI collective-cost model for the "
                     "node-sharded solve (BASELINE config 5; "
                     "parallel/costmodel.py) — predictions for the "
                     "first real multi-chip run to falsify"),
            "inputs": asdict(self),
            "per_round_collectives_bytes": self.per_round_collectives(),
            "prediction": self.predict(),
            "anchors": {
                "single_chip_tpu_50k": (
                    "benchres/bench_tpu_r05_full.json config5_sharded_50k: "
                    "7270 pods/s, 200k pods, 98 rounds, 1.29 GB RSS — the "
                    "measured S the v5e-8 prediction scales from"),
                "single_device_cpu_50k": "benchres/config5_cpu_mesh_r04.json"
                                          " steady 144 pods/s, 2 rounds/batch",
                "virtual_8dev_cpu": ("benchres/config5_cpu_mesh_r04_8dev"
                                     ".json 1.5 pods/s — 8 shards "
                                     "timesharing ONE core plus emulated "
                                     "collectives; a lower bound on "
                                     "nothing, recorded for contrast"),
            },
        }


def config5_model(devices: int = 8) -> CollectiveCostModel:
    """The BASELINE config-5 shape: 50k nodes (padded 65536), 4096-pod
    batches, v5e-8 mesh."""
    return CollectiveCostModel(devices=devices, pods_per_batch=4096,
                               nodes_padded=65536)


def model_efficiency(devices: int, pods: int, nodes: int,
                     batch: int = 4096) -> float:
    """THE analytic scale-out efficiency for a (devices, pods, nodes)
    shape — the single figure every surface must agree on: the
    weak-scaling bench (``scripts/bench_mesh_scale.py``), the runtime
    perf ledger's mesh-cycle predictions (``obs/ledger.py``), and the
    committed ``mesh_r*.json`` records all call HERE, so bench and
    runtime can never disagree on what "the model" claims (pinned by
    the parity test in tests/test_ledger.py).

    ``pods`` is capped at ``batch`` (the per-cycle solve shape) and
    ``nodes`` pads to the same power-of-two bucket the device tables
    use. Single-device shapes are 1.0 by definition — there is nothing
    to scale out."""
    if devices < 2:
        return 1.0
    from kubernetes_tpu_torch.utils.interner import bucket_size

    m = CollectiveCostModel(devices=devices,
                            pods_per_batch=max(min(pods, batch), 1),
                            nodes_padded=bucket_size(max(nodes, 1)))
    return float(m.predict()["scaleout_efficiency_cpu_anchor"])
