"""The port's device tables against the JAX package's: the same
``SnapshotPacker`` tables through both converters give equal arrays,
field by field and dtype by dtype; the port's own copy of the packer
packs the same tables; and the in-place delta scatter equals a full
upload."""

import random

import numpy as np
import pytest

import kubernetes_tpu.ops.arrays as ja
import kubernetes_tpu_torch.ops.arrays as ta
from kubernetes_tpu_torch.snapshot import SnapshotPacker as TPacker
from test_predicates import random_cluster
from torch_parity import jax_tables, random_volume_cluster, to_port


def _assert_same(jt, tt):
    assert type(jt)._fields == type(tt)._fields
    for f in type(jt)._fields:
        want = np.asarray(getattr(jt, f))
        got = getattr(tt, f).numpy()
        assert got.dtype == want.dtype, (f, got.dtype, want.dtype)
        assert got.shape == want.shape, (f, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("seed", range(4))
def test_converters_match_field_by_field(seed):
    rng = random.Random(40 + seed)
    nodes, scheduled, pending = random_cluster(rng, n_nodes=9, n_sched=12,
                                               n_pending=11)
    _dn, _dp, _ds, _dv, nt, pt, pk = jax_tables(nodes, scheduled, pending)
    st = pk.pack_selector_tables()
    _assert_same(ja.nodes_to_device(nt), ta.nodes_to_device(nt, device="cpu"))
    _assert_same(ja.nodes_to_device(nt, pad_to=32),
                 ta.nodes_to_device(nt, pad_to=32, device="cpu"))
    _assert_same(ja.pods_to_device(pt), ta.pods_to_device(pt, device="cpu"))
    _assert_same(ja.selectors_to_device(st),
                 ta.selectors_to_device(st, device="cpu"))


@pytest.mark.parametrize("seed", range(3))
def test_volume_converter_matches(seed):
    nodes, scheduled, pending, pvcs, pvs, classes = random_volume_cluster(
        70 + seed)
    *_, pk = jax_tables(nodes, scheduled, pending, pvcs, pvs, classes,
                        volumes=True)
    vt = pk.pack_volume_tables(pending)
    _assert_same(ja.volumes_to_device(vt),
                 ta.volumes_to_device(vt, device="cpu"))


@pytest.mark.parametrize("seed", range(3))
def test_port_packer_packs_the_same_tables(seed):
    rng = random.Random(90 + seed)
    nodes, scheduled, pending = random_cluster(rng, n_nodes=8, n_sched=10,
                                               n_pending=9)
    jdn, jdp, jds, _dv, *_ = jax_tables(nodes, scheduled, pending)
    tp = TPacker()
    for p in to_port(scheduled) + to_port(pending):
        tp.intern_pod(p)
    nt = tp.pack_nodes(to_port(nodes), to_port(scheduled))
    pt = tp.pack_pods(to_port(pending))
    _assert_same(jdn, ta.nodes_to_device(nt, device="cpu"))
    _assert_same(jdp, ta.pods_to_device(pt, device="cpu"))
    _assert_same(jds, ta.selectors_to_device(tp.pack_selector_tables(),
                                             device="cpu"))


def test_scatter_node_rows_equals_full_upload():
    from kubernetes_tpu_torch.cache import SchedulerCache
    from kubernetes_tpu_torch.testing import make_node, make_pod

    cache = SchedulerCache(device="cpu", max_dirty_frac=1.0)
    for i in range(6):
        cache.add_node(make_node(f"n{i}", cpu_milli=4000))
    cache.add_pod(make_pod("a", cpu_milli=100, node_name="n1"))
    _t, dev, mode = cache.device_snapshot()
    assert mode == "full"
    cache.add_pod(make_pod("b", cpu_milli=300, memory=2**20,
                           node_name="n4"))
    cache.remove_pod("default/a")
    nt, dev, mode = cache.device_snapshot()
    assert mode == "delta" and cache.last_upload_rows == 2
    _assert_same(ta.nodes_to_device(nt, device="cpu")
                 ._replace(valid=dev.valid.numpy()), dev)
    assert cache.device_snapshot()[2] == "clean"
