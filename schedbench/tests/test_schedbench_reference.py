"""The plain reference catches placements broken by hand, the control
fails, and a run whose timed path is broken underneath comes out
``correct: false`` for each fault a cell can have."""

import numpy as np
import pytest

from schedbench.control import DROPS, drops_for
from schedbench.core import workload
from schedbench.core.harness import Control, run_cell
from schedbench.core.program import Program
from schedbench.reference import plain
from tiny import CELLS, tiny

def _world(name="sched-perf-5k.affinity", pool=64):
    cell = tiny(name)
    nodes = workload.make_nodes(cell.config)
    pods = workload.make_pods(cell.config, cell.mix, pool, 1)
    n_pre = workload.prefill_count(cell.config)
    pre = np.arange(n_pre)
    return cell, nodes, pods, pre, workload.prefill_nodes(cell.config,
                                                          len(nodes))


def _judge(bound, where, name="sched-perf-5k.affinity", failed=(),
           attempted=None):
    cell, nodes, pods, pre, pre_nodes = _world(name)
    pending = np.arange(len(pre), len(pods))
    c = plain.Cycle(np.array(bound), np.array(where), np.array(failed, int),
                    len(bound) if attempted is None else attempted, 1,
                    np.array([], int))
    return plain.judge(nodes, pods, pre, pre_nodes, pending, [c], 4)


def _best(name="sched-perf-5k.affinity"):
    """Eight pending pods each on a best node of the reference's at the
    start, one pod a node."""
    cell, nodes, pods, pre, pre_nodes = _world(name)
    st = plain.State.empty(len(nodes))
    st.apply(pods, pre, pre_nodes)
    bound, where = [], []
    for i in range(len(pre), len(pre) + 8):
        fit, score = plain.class_row(nodes, st, plain.pod_class(pods, i))
        score = np.where(fit, score, -1)
        score[where] = -1
        bound.append(i)
        where.append(int(np.argmax(score)))
    return bound, where, nodes, pods


def test_sound_placements_read_clean():
    bound, where, _, _ = _best()
    n = _judge(bound, where)
    assert all(v == 0 for v in n.values()), n


def test_over_full_node_is_caught():
    bound, where, nodes, pods = _best()
    # one node given far more pods than its 4 CPU hold
    many = list(range(bound[0], bound[0] + 50))
    n = _judge(many, [3] * len(many))
    assert n["over_capacity"] >= 1 and n["node_cap_excess"] >= 1


def test_tainted_node_is_caught():
    bound, where, nodes, pods = _best()
    i = next(b for b in bound if not pods.tolerates[b])
    tainted = int(np.flatnonzero(nodes.soft_taint
                                 & (nodes.zone != pods.pref_zone[i]))[0])
    n = _judge([i], [tainted])
    assert n["score_gap"] >= 10


def test_double_bind_is_caught():
    bound, where, _, _ = _best()
    n = _judge(bound + bound[:1], where + where[:1])
    assert n["double_binds"] == 1
    # a pre-filled pod (already bound) bound again
    n = _judge([0], [5])
    assert n["double_binds"] == 1


def test_unplaced_and_lost_are_caught():
    bound, where, _, _ = _best()
    n = _judge(bound[:4], where[:4], failed=bound[4:6], attempted=8)
    assert n["unplaced_with_room"] == 2 and n["lost"] == 2


@pytest.mark.parametrize("fits", [True, False])
def test_idle_cycle_counts_only_while_a_pending_pod_fits(fits):
    """A cycle that attempts nothing is idle while a pending pod fits a
    node; on a cluster with room for none there is nothing to attempt."""
    cell, nodes, pods, pre, pre_nodes = _world()
    if not fits:
        pods.cpu[len(pre):] = nodes.cpu.max() + 1
    none = np.array([], int)
    c = plain.Cycle(none, none, none, 0, 0, none)
    n = plain.judge(nodes, pods, pre, pre_nodes,
                    np.arange(len(pre), len(pods)), [c], 4)
    assert n["idle_cycles"] == int(fits)


CONTROLS = [(name, drop) for name in CELLS
            for drop in drops_for(tiny(name).mix)]


@pytest.mark.parametrize("name,drop", CONTROLS,
                         ids=[f"{n}-{d}" for n, d in CONTROLS])
def test_control_fails_through_score_gap(name, drop):
    """Each control (the whole pair, or either half of it, left out)
    comes out not correct, and through ``score_gap``: the number that
    holds the priorities."""
    out = run_cell(tiny(name), 21, 0.3, False, device="cpu",
                   system_factory=lambda c, n, p: Control(c, n, p,
                                                          DROPS[drop]))
    assert not out.result["correct"]
    assert out.checks["score_gap"]["value"] > out.checks["score_gap"]["limit"]


# -- the timed path broken underneath --------------------------------------


class Unchanged(Program):
    """A cycle that returns with the state unchanged: pods popped, none
    placed or reported."""

    def cycle(self):
        out = super().cycle()
        return type(out)(out.bound[:0], out.nodes[:0], out.failed,
                         out.attempted, out.rounds, out.host_syncs,
                         out.graph_captures, out.spans, out.cycle_span)


class HalfLeftOut(Program):
    """Half of each batch bound, the other half dropped silently."""

    def cycle(self):
        out = super().cycle()
        h = len(out.bound) // 2
        for i in out.bound[h:].tolist():
            self.sched.on_pod_delete(self.objs[i])
        return type(out)(out.bound[:h], out.nodes[:h], out.failed,
                         out.attempted, out.rounds, out.host_syncs,
                         out.graph_captures, out.spans, out.cycle_span)


class Altered(Program):
    """Every 16th answer altered where it is produced: the pod is bound to
    the next node."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        real = self.sched._admit_pod
        n = len(self.nodes)
        seen = [0]

        def admit(pod, node_name, cycle, res):
            seen[0] += 1
            if seen[0] % 16 == 0:
                i = int(node_name.split("-")[1])
                node_name = f"node-{(i + 1) % n}"
            return real(pod, node_name, cycle, res)

        self.sched._admit_pod = admit


@pytest.mark.parametrize("fault", [Unchanged, HalfLeftOut, Altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault):
    out = run_cell(tiny(name), 33, 0.3, False, device="cpu",
                   system_factory=lambda c, n, p: fault(c, n, p, "cpu"))
    assert not out.result["correct"], out.checks
