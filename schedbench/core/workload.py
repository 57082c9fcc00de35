"""Plain descriptions of a cell's cluster and pods, made from the seed.

Both sides start from these tables: the program under test turns them
into its own objects (``core/program.py``), the plain reference
(``reference/plain.py``) reads them as they are. Nothing here imports
the program.

Nodes and pods are columns of NumPy arrays, one row a node or a pod.
A pod id indexes one table that holds the pre-filled (already bound)
pods first and then the pool of pending pods the traffic draws from.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction

import numpy as np

MI = 2**20


def rng_for(seed: int) -> np.random.Generator:
    """The traffic's generator: any whole seed, negative or past 64
    bits, maps to a stream of its own."""
    return np.random.default_rng([seed & (2**64 - 1), 1])


@dataclass
class Nodes:
    cpu: np.ndarray        # allocatable milli-CPU, int64
    mem: np.ndarray        # allocatable bytes, int64
    pods: np.ndarray       # allocatable pod count, int64
    zone: np.ndarray       # zone index, int64
    soft_taint: np.ndarray  # carries the PreferNoSchedule taint, bool
    zones: int
    soft_taint_key: str

    def __len__(self) -> int:
        return len(self.cpu)

    @staticmethod
    def name(i: int) -> str:
        return f"node-{i}"


@dataclass
class Pods:
    cpu: np.ndarray         # requested milli-CPU, int64
    mem: np.ndarray         # requested bytes, int64
    pref_zone: np.ndarray   # preferred zone (-1: none), int64
    pref_weight: np.ndarray  # weight of that preference, int64
    tolerates: np.ndarray   # tolerates the soft taint, bool

    def __len__(self) -> int:
        return len(self.cpu)


def _blocks(n: int, combos: np.ndarray,
            rng: np.random.Generator) -> np.ndarray:
    """``n`` rows of ``combos``, every combination once in each block of
    ``len(combos)`` rows, in a seeded order: each seed gets the same set
    of pods in another order."""
    k = len(combos)
    blocks = math.ceil(n / k)
    order = np.argsort(rng.random((blocks, k)), axis=1)
    return combos[order.reshape(-1)[:n]]


def _flags(share: float) -> np.ndarray:
    """The smallest run of flags with ``share`` of them set."""
    frac = Fraction(share).limit_denominator(64)
    out = np.zeros(frac.denominator, dtype=bool)
    out[:frac.numerator] = True
    return out


def make_nodes(cfg: dict) -> Nodes:
    """The configuration's cluster: ``nodes`` nodes of one shape over
    ``zones`` zones of consecutive nodes (node ``i`` in zone
    ``i * zones // nodes``), every ``soft_taint_every``-th node carrying
    the soft taint, so that each zone holds tainted and untainted
    nodes."""
    n = int(cfg["nodes"])
    idx = np.arange(n, dtype=np.int64)
    every = int(cfg.get("soft_taint_every", 0))
    return Nodes(
        cpu=np.full(n, int(cfg["node_cpu_milli"]), dtype=np.int64),
        mem=np.full(n, int(cfg["node_memory_mi"]) * MI, dtype=np.int64),
        pods=np.full(n, int(cfg["node_pods"]), dtype=np.int64),
        zone=idx * int(cfg["zones"]) // n,
        soft_taint=(idx % every == 0) if every else np.zeros(n, bool),
        zones=int(cfg["zones"]),
        soft_taint_key=cfg.get("soft_taint_key", ""))


def prefill_count(cfg: dict) -> int:
    return int(cfg.get("existing_pods", 0))


def make_pods(cfg: dict, mix: dict, pool: int, seed: int) -> Pods:
    """The pod table: the configuration's pre-filled pods (its
    ``existing_pod`` shape, no preference, no toleration) and then
    ``pool`` pending pods of the traffic mix, drawn from the seed."""
    n_pre = prefill_count(cfg)
    rng = rng_for(seed)
    pod = mix["pod"]
    pref = mix.get("preferred_zone")
    tol = mix.get("tolerate_soft_taint")
    zones = np.arange(int(cfg["zones"])) if pref else np.array([-1])
    flags = _flags(float(tol["share"])) if tol else np.array([False])
    combos = np.array([(z, f) for z in zones for f in flags], dtype=np.int64)
    rows = _blocks(pool, combos, rng)
    pref_zone = rows[:, 0]
    pref_w = np.full(pool, int(pref["weight"]) if pref else 0, np.int64)
    tolerates = rows[:, 1].astype(bool)
    ex = cfg.get("existing_pod", {"cpu_milli": 0, "memory_mi": 0})
    cat = np.concatenate
    return Pods(
        cpu=cat([np.full(n_pre, int(ex["cpu_milli"]), np.int64),
                 np.full(pool, int(pod["cpu_milli"]), np.int64)]),
        mem=cat([np.full(n_pre, int(ex["memory_mi"]) * MI, np.int64),
                 np.full(pool, int(pod["memory_mi"]) * MI, np.int64)]),
        pref_zone=cat([np.full(n_pre, -1, np.int64), pref_zone]),
        pref_weight=cat([np.zeros(n_pre, np.int64), pref_w]),
        tolerates=cat([np.zeros(n_pre, dtype=bool), tolerates]))


def prefill_nodes(cfg: dict, n_nodes: int) -> np.ndarray:
    """Node of each pre-filled pod: round robin from node 0."""
    return np.arange(prefill_count(cfg), dtype=np.int64) % n_nodes


def backlog(cfg: dict) -> int:
    """Pending pods held at every cycle boundary: the configuration's
    ``pending_pods``, the backlog its source states."""
    return int(cfg["pending_pods"])


def pool_size(cfg: dict, mix: dict, seconds: float) -> int:
    """Pending pods made at set-up: the backlog, the warm cycles' binds
    and ``pool_pods_per_s`` for every second of the window."""
    batch = int(cfg["scheduler"]["maxBatch"])
    return (backlog(cfg)
            + int(mix["warm_cycles_max"]) * batch
            + int(math.ceil(float(mix["pool_pods_per_s"]) * seconds)))
