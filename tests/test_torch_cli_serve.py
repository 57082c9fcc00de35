"""The port's executable serve loop (``python -m kubernetes_tpu_torch``,
``cli.run``): the process boots from a configuration file on the CPU
when asked (``--device cpu``), serves ``/healthz`` and ``/metrics``,
takes the lease in its lock file and exits 0 on SIGTERM; without a card
the default ``--device cuda`` exits non-zero naming it; ``cli.run``'s
serving and legacy branches bind what arrives, the legacy one never
solves while idle, a shutdown releases the lease, and
``unported_features`` now passes the serving and leadership settings
while it keeps refusing the rest."""

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from kubernetes_tpu_torch import cli
from kubernetes_tpu_torch.config import (
    IncidentsConfig,
    JourneysConfig,
    KubeSchedulerConfiguration,
    LeaderElectionConfig,
    LedgerConfig,
    LockSanitizerConfig,
    MemoryLedgerConfig,
    ObservabilityConfig,
    ParallelConfig,
    RecoveryConfig,
    RobustnessConfig,
    ScenarioConfig,
    ServingConfig,
)
from kubernetes_tpu_torch.scheduler import Scheduler
from kubernetes_tpu_torch.testing import make_node, make_pod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    return env


def test_cli_boots_server_from_config_file_on_the_cpu(tmp_path):
    """End to end: ``python -m kubernetes_tpu_torch --device cpu --config
    f`` boots, serves /healthz + /metrics, takes the lease in the lock
    file, and shuts down cleanly (rc 0) on SIGTERM."""
    cfg = tmp_path / "sched.json"
    cfg.write_text(json.dumps({
        "scheduler_name": "e2e", "solver": "batch",
        "leader_election": {"leader_elect": True,
                            "retry_period_s": 0.5},
        "serving": {"enabled": True}}))
    lock = tmp_path / "leader.lock"
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubernetes_tpu_torch", "--device", "cpu",
         "--config", str(cfg), "--port", str(port), "--lock-file",
         str(lock)],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 45
        body = None
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise AssertionError(
                    f"process exited rc={proc.returncode}: "
                    f"{proc.stderr.read().decode()[-500:]}")
            try:
                body = urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=2).read()
                break
            except OSError:
                time.sleep(0.2)
        assert body == b"ok"
        metrics = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=2).read().decode()
        assert "scheduler_schedule_attempts_total" in metrics
        while not lock.exists() and time.monotonic() < deadline:
            time.sleep(0.2)
        assert lock.exists()
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
        assert proc.returncode == 0
        # release_lease_on_shutdown: the record is the expired anonymous one
        rec = json.loads(lock.read_text())
        assert rec["holder_identity"] == "" and rec["lease_duration_s"] == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_cli_without_a_card_exits_nonzero_naming_it(tmp_path):
    cfg = tmp_path / "sched.json"
    cfg.write_text(json.dumps({"solver": "batch"}))
    out = subprocess.run(
        [sys.executable, "-m", "kubernetes_tpu_torch", "--config", str(cfg),
         "--port", "0"],
        env=_env(), cwd=REPO, capture_output=True, text=True, timeout=60)
    assert out.returncode != 0
    assert "cuda" in out.stderr and "is_available() is False" in out.stderr
    assert "serving healthz" not in out.stderr


def _run_in_thread(monkeypatch, sched, cfg, argv):
    monkeypatch.setattr(Scheduler, "from_config",
                        classmethod(lambda cls, c, **kw: sched))
    args = cli.build_parser().parse_args(["--port", "0", *argv])
    stop = threading.Event()
    t = threading.Thread(target=cli.run, args=(cfg, args, stop))
    t.start()
    return stop, t


def _wait(cond, limit=10.0):
    deadline = time.monotonic() + limit
    while time.monotonic() < deadline and not cond():
        time.sleep(0.02)
    return cond()


def test_legacy_run_skips_the_solve_while_idle(monkeypatch):
    """cli.run's legacy loop mints no cycle while the queue is empty and
    no doorbell rang, and still schedules promptly once work arrives."""
    sched = Scheduler(device="cpu", enable_preemption=False)
    sched.on_node_add(make_node("n0"))
    cycles = {"n": 0}
    orig = sched.schedule_cycle

    def counting_cycle(*a, **kw):
        cycles["n"] += 1
        return orig(*a, **kw)

    sched.schedule_cycle = counting_cycle
    cfg = dataclasses.replace(
        KubeSchedulerConfiguration(),
        leader_election=LeaderElectionConfig(leader_elect=False))
    stop, t = _run_in_thread(monkeypatch, sched, cfg,
                             ["--cycle-interval", "0.01"])
    try:
        time.sleep(0.3)  # ~30 idle intervals
        assert cycles["n"] == 0 and sched.obs.last_trace is None
        sched.on_pod_add(make_pod("wake", cpu_milli=100))  # rings
        assert _wait(lambda: len(sched.queue) == 0)
        assert cycles["n"] >= 1
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()


def test_serving_run_takes_the_lease_binds_and_releases(monkeypatch,
                                                        tmp_path):
    """cli.run's serving branch: the ServingRuntime behind the elector on
    a FileLock, the lazy warmup after the node sync, every pod bound, and
    the lease released on shutdown."""
    from kubernetes_tpu_torch.leaderelection import FileLock

    sched = Scheduler(device="cpu", enable_preemption=False)
    for i in range(4):
        sched.on_node_add(make_node(f"n{i}"))
    cfg = dataclasses.replace(
        KubeSchedulerConfiguration(),
        leader_election=LeaderElectionConfig(retry_period_s=0.2,
                                             renew_deadline_s=1.0,
                                             lease_duration_s=2.0),
        serving=ServingConfig(enabled=True, max_wait_s=0.02,
                              idle_wait_s=0.05))
    cfg.warmup.enabled = True
    cfg.warmup.pod_buckets = (8,)
    lock = tmp_path / "lease.json"
    stop, t = _run_in_thread(monkeypatch, sched, cfg,
                             ["--lock-file", str(lock)])
    try:
        assert _wait(lambda: sched.fence is not None
                     and sched.fence.is_leader())
        for i in range(12):
            sched.on_pod_add(make_pod(f"s{i}", cpu_milli=100))
        assert _wait(lambda: sched.cache.pod_count() == 12)
        assert sched.metrics.recovery_takeovers.value() == 1
        assert sched.metrics.warmup_compiles.value() >= 1
        assert FileLock(str(lock)).get().holder_identity
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()
    assert FileLock(str(lock)).get().holder_identity == ""
    assert sched.metrics.microbatch_flushes.value(trigger="max-wait") \
        + sched.metrics.microbatch_flushes.value(trigger="bucket-fill") >= 1


@pytest.mark.parametrize("field,value", [
    ("serving", ServingConfig(enabled=True)),
    ("recovery", RecoveryConfig(fenced_binds=False)),
    ("recovery", RecoveryConfig(reconcile_on_takeover=False,
                                release_lease_on_shutdown=False)),
    ("robustness", RobustnessConfig(watch_progress_deadline_s=7.0)),
    ("recovery", RecoveryConfig(device_reset_limit=4)),
    ("recovery", RecoveryConfig(device_cooloff_s=1.0)),
    ("robustness", RobustnessConfig(bind_verify_retries=5)),
    ("observability", ObservabilityConfig(audit_interval_s=5.0)),
    ("device_resident_snapshot", False),
    ("observability", ObservabilityConfig(
        journeys=JourneysConfig(enabled=False))),
    ("observability", ObservabilityConfig(
        enabled=False, trace_sampling=0.5, recorder_capacity=8,
        trace_ring_capacity=4, retrace_storm_threshold=2,
        retrace_storm_window=16)),
    ("observability", ObservabilityConfig(
        lock_sanitizer=LockSanitizerConfig(enabled=True))),
])
def test_serving_and_leadership_settings_are_ported(field, value):
    cfg = dataclasses.replace(KubeSchedulerConfiguration(), **{field: value})
    assert cli.validate_config(cfg) == []
    assert cli.unported_features(cfg) == []


@pytest.mark.parametrize("field,value,item", [
    ("parallel", ParallelConfig(mesh=4), "A.17"),
    ("scenario", ScenarioConfig(pack="consolidation"), "A.15"),
    ("observability", ObservabilityConfig(
        memory_ledger=MemoryLedgerConfig(enabled=False)), "A.13"),
    ("observability", ObservabilityConfig(
        ledger=LedgerConfig(enabled=False)), "A.13"),
    ("observability", ObservabilityConfig(
        incidents=IncidentsConfig(enabled=False)), "A.13"),
])
def test_unported_settings_stay_refused(field, value, item):
    cfg = dataclasses.replace(KubeSchedulerConfiguration(), **{field: value})
    errs = cli.unported_features(cfg)
    assert len(errs) == 1 and f"ROADMAP {item}" in errs[0], errs


def test_device_flag_defaults_to_the_card():
    assert cli.build_parser().parse_args([]).device == "cuda"
    assert cli.build_parser().parse_args(["--device", "cpu"]).device == "cpu"
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--device", "tpu"])
