"""Hygiene gates for the PyTorch port (``kubernetes_tpu_torch``): it
imports neither JAX nor the JAX package, every file byte-compiles (the
repo's parse gate does not cover the new root), its entry points default
to the card and refuse to fall back to the CPU, on CPU tensors every
kernel wrapper takes its plain version without counting a launch, and a
kernel fault is never mistaken for a solver fault."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "kubernetes_tpu_torch")


def _port_modules():
    mods = []
    for dirpath, dirnames, filenames in os.walk(PORT):
        dirnames[:] = [d for d in dirnames if not d.startswith(("_", "."))]
        for f in sorted(filenames):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), REPO)[:-3]
            mod = rel.replace(os.sep, ".")
            mods.append(mod[: -len(".__init__")]
                        if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = _port_modules()
    assert "kubernetes_tpu_torch.scheduler" in mods
    code = (
        "import importlib, json, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'kubernetes_tpu'\n"
        "             or m.startswith('kubernetes_tpu.'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_port_imports_neither_protobuf_nor_grpc():
    """The card's machine has no ``protobuf`` or ``grpcio``: the port keeps
    its own proto3 codec (``proto/``, no generated ``*_pb2.py`` file), and
    importing every module of the port, the gRPC seam and the codec
    included, loads no ``grpc``, no ``google.protobuf`` and no ``_pb2``
    module."""
    mods = _port_modules()
    assert {"kubernetes_tpu_torch.restapi", "kubernetes_tpu_torch.kubectl",
            "kubernetes_tpu_torch.sim", "kubernetes_tpu_torch.grpc_shim",
            "kubernetes_tpu_torch.api.protobuf",
            "kubernetes_tpu_torch.proto.wire"} <= set(mods)
    pb2 = [os.path.join(d, f) for d, _dirs, files in os.walk(PORT)
           for f in files if f.endswith("_pb2.py")]
    assert pb2 == []
    code = (
        "import importlib, json, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] == 'grpc'\n"
        "             or m == 'google.protobuf'\n"
        "             or m.startswith('google.protobuf.')\n"
        "             or '_pb2' in m)\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_grpc_transport_raises_naming_grpcio_where_it_is_absent():
    """Without ``grpc`` importable, the seam's codec, service and bridge
    still import and work, and ``serve_grpc``, ``_handlers`` and
    ``GrpcSchedulerClient`` raise ImportError naming ``grpcio`` (never a
    fall back to another transport)."""
    code = (
        "import json, sys\n"
        "sys.modules['grpc'] = None\n"
        "from kubernetes_tpu_torch import grpc_shim\n"
        "from kubernetes_tpu_torch.proto import extender as pb\n"
        "from kubernetes_tpu_torch.scheduler import Scheduler\n"
        "sched = Scheduler(device='cpu', enable_preemption=False)\n"
        "svc = grpc_shim.TpuSchedulerService(sched)\n"
        "acks = list(svc.sync_state(iter([pb.SnapshotDelta(revision=4)]),"
        " None))\n"
        "out = {'ack': acks[0].revision}\n"
        "for name, call in (\n"
        "        ('serve_grpc', lambda: grpc_shim.serve_grpc(sched)),\n"
        "        ('_handlers', lambda: grpc_shim._handlers(svc)),\n"
        "        ('client', lambda: grpc_shim.GrpcSchedulerClient('x:1'))):\n"
        "    try:\n"
        "        call()\n"
        "        out[name] = None\n"
        "    except ImportError as e:\n"
        "        out[name] = str(e)\n"
        "print(json.dumps(out))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got.pop("ack") == 4
    for name, msg in got.items():
        assert msg and "grpcio is not installed" in msg, name


def test_port_files_byte_compile():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _dirs, filenames in os.walk(PORT):
        files += [os.path.join(dirpath, f) for f in filenames
                  if f.endswith(".py")]
    assert len(files) > 15
    for path in files:
        with open(path, encoding="utf-8") as fh:
            compile(fh.read(), path, "exec")


def test_entry_points_default_to_cuda_and_refuse_cpu_fallback(monkeypatch):
    from kubernetes_tpu_torch import resolve_device
    from kubernetes_tpu_torch.scheduler import Scheduler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Scheduler()
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    assert Scheduler(device="cpu").device.type == "cpu"


def test_hollow_cluster_builds_its_scheduler_on_the_card(monkeypatch):
    """The hub builds the port's Scheduler at its defaults: on the card,
    raising without one, never a quiet fall back to the CPU."""
    from kubernetes_tpu_torch.sim import HollowCluster

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        HollowCluster()
    with pytest.raises(RuntimeError, match="cuda"):
        HollowCluster(seed=4, admission=True, scheduler_kw={})
    hub = HollowCluster(scheduler_kw={"device": "cpu"})
    assert hub.sched.device.type == "cpu"


def test_table_converters_default_to_cuda_and_refuse_cpu_fallback(
        monkeypatch):
    from kubernetes_tpu_torch.ops.arrays import DeviceSelectors, from_numpy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fields = {f: np.zeros((2, 4), np.int32) for f in DeviceSelectors._fields}
    with pytest.raises(RuntimeError, match="cuda"):
        from_numpy("selectors", fields)
    got = from_numpy("selectors", fields, device="cpu")
    assert all(t.device.type == "cpu" for t in got)


def test_kernel_faults_are_not_solver_faults():
    from kubernetes_tpu_torch import kernels

    # the solver ladder falls through on RuntimeError; a kernel fault
    # must not be one, or a broken kernel would hide behind greedy
    assert not issubclass(kernels.KernelError, RuntimeError)
    with pytest.raises(kernels.KernelError, match="CUDA error 700"):
        kernels.check(700, "fused_pair_normalize")
    kernels.check(0, "fused_pair_normalize")


@pytest.mark.parametrize("n, offset, ok", [
    (8, 0, True), (6, 0, False), (8, 1, False)])
def test_vector_reads_need_whole_aligned_rows(n, offset, ok):
    from kubernetes_tpu_torch import kernels

    t = torch.zeros(n + 4)[offset: offset + n]
    if ok:
        kernels.require_vec4(n, "k", t)
    else:
        with pytest.raises(ValueError, match="multiple of 4|aligned"):
            kernels.require_vec4(n, "k", t)


def test_wrappers_take_the_plain_version_on_cpu_tensors():
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.ops import fused_score, sinkhorn

    gen = torch.Generator().manual_seed(3)
    rf = torch.randint(0, 4, (8, 12), generator=gen).float() * 50
    rr = torch.randint(0, 2, (8, 12), generator=gen).float()
    mask = torch.rand((8, 12), generator=gen) > 0.2
    kernels.reset_launches()
    got = fused_score.fused_pair_normalize(rf, rr, mask, 1.0, 2.0)
    want = fused_score.fused_pair_normalize_plain(rf, rr, mask, 1.0, 2.0)
    assert torch.equal(got, want)
    logk = torch.where(mask, -rf / 50, sinkhorn.NEG_INF)
    zr, zc = torch.zeros(8), torch.zeros(12)
    assert torch.equal(sinkhorn.sinkhorn_u(logk, zc, zr),
                       sinkhorn.sinkhorn_u_plain(logk, zc, zr))
    assert torch.equal(sinkhorn.sinkhorn_v(logk, zr, zc),
                       sinkhorn.sinkhorn_v_plain(logk, zr, zc))
    assert all(n == 0 for n in kernels.LAUNCHES.values())

