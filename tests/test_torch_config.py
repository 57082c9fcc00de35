"""The configuration layer of the PyTorch port (``kubernetes_tpu_torch``
``config.py``, ``api/scheme.py``, ``api/config_v1alpha1.py``, ``cli.py``)
held against the JAX package's: every case of ``tests/test_cli.py``
(except the serve-loop boot, which waits for the serve-loop slice) and of
``tests/test_scheme.py`` runs through both packages, and the decoded
configurations must be equal field by field and the error texts equal."""

import dataclasses
import importlib
import json
import re
import types
from typing import Optional

import pytest

PKGS = ("kubernetes_tpu", "kubernetes_tpu_torch")


def _mods(pkg):
    return types.SimpleNamespace(**{
        name.rsplit(".", 1)[-1]: importlib.import_module(f"{pkg}.{name}")
        for name in ("config", "cli", "api.scheme", "api.config_v1alpha1",
                     "framework")})


REF, PORT = (_mods(p) for p in PKGS)


def plain(obj):
    """A configuration as plain data, comparable across the packages:
    dataclasses by field, feature gates by their gate map, a Policy's
    internal priority names without their per-process sequence suffix."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                {f.name: plain(getattr(obj, f.name))
                 for f in dataclasses.fields(obj)})
    if type(obj).__name__ == "FeatureGates":
        return ("FeatureGates", dict(obj._gates))
    if isinstance(obj, dict):
        return {re.sub(r"#\d+$", "#", str(k)): plain(v)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(plain(x) for x in obj)
    return obj


def outcome(fn):
    """``("ok", plain result)`` or ``("error", type name, message)``."""
    try:
        return ("ok", plain(fn()))
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("error", type(e).__name__,
                str(e).replace("kubernetes_tpu_torch", "kubernetes_tpu"))


def both(case):
    """Run ``case(modules)`` for each package; assert they agree and
    return the port's outcome."""
    got = [outcome(lambda m=m: case(m)) for m in (REF, PORT)]
    assert got[1] == got[0]
    return got[1]


def _resolve(m, argv):
    return m.cli.resolve_config(m.cli.build_parser().parse_args(argv))


# -- tests/test_cli.py --------------------------------------------------------


def test_defaults_are_valid():
    assert both(lambda m: m.cli.validate_config(
        m.config.KubeSchedulerConfiguration())) == ("ok", [])


def test_validation_rejects_bad_fields():
    got = both(lambda m: m.cli.validate_config(
        m.config.KubeSchedulerConfiguration(
            scheduler_name="", percentage_of_nodes_to_score=150,
            hard_pod_affinity_symmetric_weight=-1, solver="magic",
            per_node_cap=0)))
    joined = "\n".join(got[1])
    for frag in ("schedulerName", "percentageOfNodesToScore",
                 "hardPodAffinitySymmetricWeight", "solver", "perNodeCap"):
        assert frag in joined


def test_validation_leader_election_rules():
    got = both(lambda m: m.cli.validate_config(
        m.config.KubeSchedulerConfiguration(
            leader_election=m.config.LeaderElectionConfig(
                leader_elect=True, lease_duration_s=5.0,
                renew_deadline_s=10.0, retry_period_s=2.0))))
    assert any("leaseDuration" in e for e in got[1])
    assert both(lambda m: m.cli.validate_config(
        m.config.KubeSchedulerConfiguration(
            leader_election=m.config.LeaderElectionConfig(
                leader_elect=False, lease_duration_s=-1.0)))) == ("ok", [])


def test_decode_rejects_unknown_fields():
    got = both(lambda m: m.cli.decode_config(
        {"scheduler_name": "x", "not_a_field": 1}))
    assert got[:2] == ("error", "ConfigError") and "not_a_field" in got[2]


def test_decode_apiversion_routes_through_versioned_scheme():
    gv = "kubescheduler.config.k8s.io/v1alpha1"
    got = both(lambda m: m.cli.decode_config(
        {"apiVersion": gv, "kind": "KubeSchedulerConfiguration",
         "schedulerName": "s"}))
    fields = got[1][1]
    assert fields["scheduler_name"] == "s"
    assert fields["percentage_of_nodes_to_score"] == 0
    got = both(lambda m: m.cli.decode_config(
        {"apiVersion": gv, "kind": "KubeSchedulerConfiguration",
         "scheduler_name": "s"}))
    assert got[0] == "error" and "scheduler_name" in got[2]
    got = both(lambda m: m.cli.decode_config(
        {"apiVersion": "nope/v9", "kind": "X"}))
    assert got[:2] == ("error", "ConfigError")


def test_flag_overlay_and_gates(tmp_path):
    # JSON, so the case needs no YAML parser (the card's machine has none)
    f = tmp_path / "cfg.json"
    f.write_text(json.dumps({"scheduler_name": "from-file",
                             "solver": "greedy"}))
    got = both(lambda m: _resolve(m, [
        "--config", str(f), "--solver", "batch",
        "--feature-gates", "EvenPodsSpread=false"]))
    fields = got[1][1]
    assert fields["scheduler_name"] == "from-file"
    assert fields["solver"] == "batch"
    assert fields["feature_gates"][1]["EvenPodsSpread"] is False


def test_unknown_feature_gate_rejected():
    got = both(lambda m: _resolve(m, ["--feature-gates", "NotAGate=true"]))
    assert got[:2] == ("error", "ConfigError") and "NotAGate" in got[2]


def test_config_file_json(tmp_path):
    f = tmp_path / "cfg.json"
    f.write_text(json.dumps({"scheduler_name": "j", "per_node_cap": 2}))
    got = both(lambda m: m.cli.load_config_file(str(f)))
    assert got[1][1]["scheduler_name"] == "j"
    assert got[1][1]["per_node_cap"] == 2


def test_config_file_yaml_text_goes_to_yaml(tmp_path):
    # text that is not JSON is handed to yaml (when it is installed)
    pytest.importorskip("yaml")
    f = tmp_path / "cfg.yaml"
    f.write_text("scheduler_name: y\nsolver: greedy\n")
    got = both(lambda m: m.cli.load_config_file(str(f)))
    assert got[1][1]["solver"] == "greedy"


@pytest.mark.parametrize("doc, rc, line", [
    ({"scheduler_name": "ok"}, 0,
     "configuration valid: scheduler=ok solver=batch"),
    ({"apiVersion": "kubescheduler.config.k8s.io/v1alpha1",
      "kind": "KubeSchedulerConfiguration", "schedulerName": "v",
      "solver": "sinkhorn"}, 0,
     "configuration valid: scheduler=v solver=sinkhorn"),
    ({"nope": 1}, 1, ""),
    ({"scheduler_name": "", "per_node_cap": 0}, 1, ""),
])
def test_cli_validate_only_exit_codes(tmp_path, capsys, doc, rc, line):
    f = tmp_path / "cfg.json"
    f.write_text(json.dumps(doc))
    outs = []
    for m in (REF, PORT):
        got = m.cli.main(["--validate-only", "--config", str(f)])
        cap = capsys.readouterr()
        outs.append((got, cap.out, cap.err))
    assert outs[1] == outs[0]
    assert outs[1][0] == rc
    assert outs[1][1].strip() == line


@pytest.mark.parametrize("doc, item", [
    ({"parallel": {"mesh": 4}}, "A.17"),
    ({"parallel": {"mesh": "auto"}}, "A.17"),
    ({"parallel": {"mesh": 2}}, "A.17"),
])
def test_unported_features_are_refused_by_name(tmp_path, capsys, doc, item):
    """A valid configuration that turns on something the port does not
    have yet is refused — by --validate-only and by from_config — with
    a message naming the ROADMAP item; never silently ignored."""
    f = tmp_path / "cfg.json"
    f.write_text(json.dumps(doc))
    assert REF.cli.main(["--validate-only", "--config", str(f)]) == 0
    capsys.readouterr()
    assert PORT.cli.main(["--validate-only", "--config", str(f)]) == 1
    err = capsys.readouterr().err
    assert f"ROADMAP {item}" in err
    from kubernetes_tpu_torch.scheduler import Scheduler

    cfg = PORT.cli.load_config_file(str(f))
    with pytest.raises(PORT.cli.ConfigError, match=f"ROADMAP {item}"):
        Scheduler.from_config(cfg, device="cpu")


@pytest.mark.parametrize("spelling", ["native", "v1alpha1"])
@pytest.mark.parametrize("pack", ["consolidation", "gang-topology"])
def test_scenario_packs_are_ported(tmp_path, capsys, pack, spelling):
    """Both scenario packs are ported: a configuration naming one, in
    either spelling, validates like the reference's (rc 0), passes
    ``unported_features``, and ``Scheduler.from_config`` builds the named
    pack with the reference's priority weights."""
    doc = {"scenario": {"pack": pack}}
    if spelling == "v1alpha1":
        doc.update(apiVersion="kubescheduler.config.k8s.io/v1alpha1",
                   kind="KubeSchedulerConfiguration",
                   percentageOfNodesToScore=100)
    f = tmp_path / "cfg.json"
    f.write_text(json.dumps(doc))
    for m in (REF, PORT):
        assert m.cli.main(["--validate-only", "--config", str(f)]) == 0
        capsys.readouterr()
    from kubernetes_tpu.scheduler import Scheduler as JScheduler
    from kubernetes_tpu_torch.scheduler import Scheduler

    cfg = PORT.cli.load_config_file(str(f))
    assert cfg.scenario.pack == pack
    assert PORT.cli.unported_features(cfg) == []
    sched = Scheduler.from_config(cfg, device="cpu")
    ref = JScheduler.from_config(REF.cli.load_config_file(str(f)))
    assert sched.scenario_pack.name == ref.scenario_pack.name == pack
    assert type(sched.scenario_pack).__name__ == \
        type(ref.scenario_pack).__name__
    assert sched.weights == ref.weights
    assert sched.scenario == PORT.cli.load_config_file(str(f)).scenario


@pytest.mark.parametrize("doc, backend, field, want", [
    ({"observability": {"memory_ledger": {"preflight": False}}},
     "memledger", "preflight", False),
    ({"observability": {"ledger": {"enabled": False}}},
     "ledger", "enabled", False),
    ({"observability": {"incidents": {"enabled": False}}},
     "incidents", "enabled", False),
    ({"observability": {"memory_ledger": {"enabled": False}}},
     "memledger", "enabled", False),
])
def test_observability_backends_are_honoured(tmp_path, capsys, doc, backend,
                                             field, want):
    """The perf ledger, the memory ledger and the incident recorder are
    ported: a configuration that sets them validates like the reference's
    (rc 0) and reaches the scheduler's backend through from_config."""
    f = tmp_path / "cfg.json"
    f.write_text(json.dumps(doc))
    for m in (REF, PORT):
        assert m.cli.main(["--validate-only", "--config", str(f)]) == 0
        capsys.readouterr()
    from kubernetes_tpu_torch.scheduler import Scheduler

    cfg = PORT.cli.load_config_file(str(f))
    assert PORT.cli.unported_features(cfg) == []
    sched = Scheduler.from_config(cfg, device="cpu")
    assert getattr(getattr(sched.obs, backend).config, field) == want


@pytest.mark.parametrize("doc, field, want", [
    ({"device_resident_snapshot": False}, "device_resident_snapshot", False),
    ({"recovery": {"device_reset_limit": 4}}, "recovery.device_reset_limit",
     4),
    ({"recovery": {"device_cooloff_s": 2.5}}, "recovery.device_cooloff_s",
     2.5),
    ({"robustness": {"bind_verify_retries": 5}},
     "robustness.bind_verify_retries", 5),
    ({"observability": {"audit_interval_s": 5.0}},
     "observability.audit_interval_s", 5.0),
])
def test_recovery_settings_are_accepted_like_the_reference(tmp_path, capsys,
                                                           doc, field, want):
    """The recovery paths are ported (the ambiguous-bind protocol,
    device-loss recovery with host mode, the auditor's sweep): their
    settings validate as in the reference and reach the scheduler."""
    f = tmp_path / "cfg.json"
    f.write_text(json.dumps(doc))
    outs = []
    for m in (REF, PORT):
        got = m.cli.main(["--validate-only", "--config", str(f)])
        cap = capsys.readouterr()
        outs.append((got, cap.out, cap.err))
    assert outs[1] == outs[0] and outs[1][0] == 0
    from kubernetes_tpu_torch.scheduler import Scheduler

    cfg = PORT.cli.load_config_file(str(f))
    sched = Scheduler.from_config(cfg, device="cpu")
    got = sched
    for name in field.split("."):
        got = getattr(got, name)
    assert got == want


def test_watch_progress_deadline_is_accepted_like_the_reference(tmp_path,
                                                                capsys):
    """The informer is ported (``sim.Reflector`` honours the deadline),
    so ``robustness.watchProgressDeadline`` validates and builds in the
    port exactly as in the reference."""
    f = tmp_path / "cfg.json"
    f.write_text(json.dumps(
        {"robustness": {"watch_progress_deadline_s": 7.0}}))
    outs = []
    for m in (REF, PORT):
        got = m.cli.main(["--validate-only", "--config", str(f)])
        cap = capsys.readouterr()
        outs.append((got, cap.out, cap.err))
    assert outs[1] == outs[0] and outs[1][0] == 0
    from kubernetes_tpu_torch.scheduler import Scheduler

    cfg = PORT.cli.load_config_file(str(f))
    sched = Scheduler.from_config(cfg, device="cpu")
    assert sched.robustness.watch_progress_deadline_s == 7.0


def test_cli_without_validate_only_names_the_serve_loop_item(tmp_path,
                                                            capsys,
                                                            monkeypatch):
    """Without --validate-only, main runs the serve loop, which starts on
    the card unless --device cpu asks otherwise: with no card it exits 1
    naming it, before any server or elector starts."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f = tmp_path / "cfg.json"
    f.write_text(json.dumps({"scheduler_name": "x"}))
    assert PORT.cli.main(["--config", str(f)]) == 1
    err = capsys.readouterr().err
    assert "device 'cuda' requested" in err and "serving" not in err


def test_version_flag(capsys):
    assert PORT.cli.main(["--version"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert REF.cli.main(["--version"]) == 0
    ref = json.loads(capsys.readouterr().out)
    assert doc["gitVersion"].startswith("v0.")
    assert {k: doc[k] for k in ref} == ref


# -- tests/test_scheme.py -----------------------------------------------------


def test_parse_duration_go_forms():
    for m in (REF, PORT):
        v = m.config_v1alpha1
        assert v.parse_duration("15s") == 15.0
        assert v.parse_duration("1m30s") == 90.0
        assert v.parse_duration("2h") == 7200.0
        assert v.parse_duration("100ms") == 0.1
        assert v.parse_duration("1.5s") == 1.5
    for bad in ("", "s", "10", "5x", "1m 30s", None, [1]):
        got = both(lambda m, b=bad: m.config_v1alpha1.parse_duration(b))
        assert got[:2] == ("error", "SchemeError")


def test_format_duration_round_trips():
    for s in (0.0, 2.0, 15.0, 90.0, 7200.0, 0.1, 1.5, 3661.0):
        got = both(lambda m, s=s: m.config_v1alpha1.parse_duration(
            m.config_v1alpha1.format_duration(s)))
        assert got[1] == pytest.approx(s)
    assert both(lambda m: m.config_v1alpha1.format_duration(90.0)) == (
        "ok", "1m30s")
    assert both(lambda m: m.config_v1alpha1.format_duration(0.0)) == (
        "ok", "0s")


def test_scheme_rejects_unknown_fields_with_field_paths():
    def case(m):
        v = m.config_v1alpha1
        s = m.scheme.Scheme()
        s.register(v.GROUP_VERSION, v.KIND,
                   v.KubeSchedulerConfigurationV1alpha1)
        return s.build(v.GROUP_VERSION, v.KIND,
                       {"bogusField": 1, "leaderElection": {"alsoBogus": 2}})

    got = both(case)
    assert got[:2] == ("error", "SchemeError")
    assert "bogusField" in got[2] and "leaderElection.alsoBogus" in got[2]


def test_scheme_unknown_kind_and_missing_conversion():
    assert both(lambda m: m.scheme.Scheme().build("v9", "Nope", {}))[:2] == (
        "error", "SchemeError")

    def case(m):
        v = m.config_v1alpha1
        s = m.scheme.Scheme()
        s.register(v.GROUP_VERSION, v.KIND,
                   v.KubeSchedulerConfigurationV1alpha1)
        return s.convert(s.build(v.GROUP_VERSION, v.KIND, {}),
                         m.config.KubeSchedulerConfiguration)

    got = both(case)
    assert got[0] == "error" and "no conversion registered" in got[2]


def _decode(doc):
    return both(lambda m: m.config_v1alpha1.decode(
        {"apiVersion": m.config_v1alpha1.GROUP_VERSION,
         "kind": m.config_v1alpha1.KIND, **doc}))


def test_decode_versioned_yaml_default_convert_validate():
    got = _decode({"schedulerName": "tpu-sched",
                   "leaderElection": {"leaseDuration": "30s",
                                      "renewDeadline": "20s"},
                   "featureGates": {"EvenPodsSpread": False}})
    f = got[1][1]
    assert f["scheduler_name"] == "tpu-sched"
    assert f["leader_election"][1]["lease_duration_s"] == 30.0
    assert f["leader_election"][1]["retry_period_s"] == 2.0
    assert f["percentage_of_nodes_to_score"] == 0
    assert both(lambda m: m.cli.validate_config(m.config_v1alpha1.decode(
        {"apiVersion": m.config_v1alpha1.GROUP_VERSION,
         "kind": m.config_v1alpha1.KIND, "schedulerName": "tpu-sched"}))) \
        == ("ok", [])


def test_versioned_default_differs_from_internal_default():
    assert both(lambda m: m.config.KubeSchedulerConfiguration()
                .percentage_of_nodes_to_score) == ("ok", 100)
    assert _decode({})[1][1]["percentage_of_nodes_to_score"] == 0


def test_encode_decode_round_trip_preserves_fields():
    doc = {"schedulerName": "rt", "percentageOfNodesToScore": 37,
           "bindTimeoutSeconds": 123.0, "solver": "greedy", "perNodeCap": 2,
           "leaderElection": {"leaderElect": False, "retryPeriod": "3s"},
           "featureGates": {"EvenPodsSpread": False}}

    def case(m):
        v = m.config_v1alpha1
        cfg = v.decode({"apiVersion": v.GROUP_VERSION, "kind": v.KIND,
                        **doc})
        enc = v.encode(cfg)
        assert v.decode(enc) == cfg
        return enc

    got = both(case)
    assert got[1]["schedulerName"] == "rt"
    assert got[1]["leaderElection"]["retryPeriod"] == "3s"


@pytest.mark.parametrize("doc, frag", [
    ({"leaderElection": {"leaseDuration": "abc"}}, "leaseDuration"),
    ({"featureGates": {"NotAGate": True}}, "NotAGate"),
    ({"bindTimeoutSeconds": "600s"}, "bindTimeoutSeconds"),
    ({"algorithmSource": {"policy": {"priorities": [{"weight": 1}]}}},
     "policy"),
    ({"plugins": "DenyLabeled"}, "plugins"),
    ({"pluginConfig": [{"name": "X", "args": 5}]}, "pluginConfig[0].args"),
    ({"pluginConfig": [{"name": "X", "arg": {"a": 1}}]},
     "pluginConfig[0].arg"),
    ({"pluginConfig": [{"args": {}}]}, "pluginConfig[0].name"),
])
def test_decode_errors_are_the_same_field_errors(doc, frag):
    got = _decode(doc)
    assert got[:2] == ("error", "SchemeError") and frag in got[2]


def test_direct_convert_of_partial_object_applies_defaults():
    def case(m):
        v = m.config_v1alpha1
        raw = v.KubeSchedulerConfigurationV1alpha1(
            schedulerName="s",
            leaderElection=v.LeaderElectionConfigurationV1alpha1(
                leaseDuration="15s"))
        cfg = v.SCHEME.convert(raw, m.config.KubeSchedulerConfiguration)
        assert raw.bindTimeoutSeconds is None
        return cfg

    f = both(case)[1][1]
    assert f["bind_timeout_seconds"] == 600.0
    assert f["leader_election"][1]["renew_deadline_s"] == 10.0


@pytest.mark.parametrize("policy", [
    {"kind": "Policy", "predicates": [{"name": "PodFitsResources"}],
     "priorities": [{"name": "LeastRequestedPriority", "weight": 1}]},
    {"kind": "Policy", "predicates": [],
     "priorities": [{"name": "RequestedToCapacityRatioPriority",
                     "weight": 2, "argument": {
                         "requestedToCapacityRatioArguments": {
                             "utilizationShape": [
                                 {"utilization": 0, "score": 10},
                                 {"utilization": 100, "score": 0}]}}}],
     "extenders": [{"urlPrefix": "http://127.0.0.1:1/x",
                    "filterVerb": "filter", "weight": 3,
                    "ignorable": True}]},
])
def test_policy_source_converts(policy):
    got = _decode({"algorithmSource": {"policy": policy}})
    pol = got[1][1]["policy"]
    assert pol[0] == "Policy"


class _DenyLabeled:
    """A PreFilter plugin built from ``args`` against one package's
    framework (registered in both, the same way)."""

    @staticmethod
    def build(fw):
        class DenyLabeled(fw.Plugin):
            def __init__(self, args):
                self.label = args.get("label", "quarantine")

            def name(self):
                return "DenyLabeled"

            def pre_filter(self, state, pod):
                if pod.labels.get(self.label):
                    return fw.Status(fw.UNSCHEDULABLE,
                                     f"label {self.label} set")
                return fw.Status()

        return DenyLabeled


def test_plugins_and_plugin_config_end_to_end():
    """Plugins + PluginConfig decode, round-trip and assemble the
    framework through both packages' ``Scheduler.from_config``; the two
    schedulers bind and fail the same pods with the same reasons."""
    from kubernetes_tpu.scheduler import Scheduler as JScheduler
    from kubernetes_tpu.testing import make_node, make_pod
    from kubernetes_tpu_torch.scheduler import Scheduler as TScheduler
    from torch_parity import to_port

    for m in (REF, PORT):
        m.framework.register_plugin("DenyLabeled",
                                    _DenyLabeled.build(m.framework))
    try:
        doc = {"plugins": ["DenyLabeled"],
               "pluginConfig": [{"name": "DenyLabeled",
                                 "args": {"label": "blocked"}}]}
        cfgs = []
        for m in (REF, PORT):
            v = m.config_v1alpha1
            cfg = v.decode({"apiVersion": v.GROUP_VERSION, "kind": v.KIND,
                            **doc})
            assert cfg.plugins == ("DenyLabeled",)
            assert v.decode(v.encode(cfg)) == cfg
            cfgs.append(cfg)
        assert plain(cfgs[0]) == plain(cfgs[1])
        js = JScheduler.from_config(cfgs[0], enable_preemption=False)
        ts = TScheduler.from_config(cfgs[1], enable_preemption=False,
                                    device="cpu")
        results = []
        for s, conv in ((js, lambda x: x), (ts, to_port)):
            s.on_node_add(conv(make_node("n0", cpu_milli=4000)))
            s.on_pod_add(conv(make_pod("ok", cpu_milli=100)))
            s.on_pod_add(conv(make_pod("nope", cpu_milli=100,
                                       labels={"blocked": "1"})))
            r = s.schedule_cycle()
            results.append((r.assignments, r.failure_reasons))
        assert results[1] == results[0]
        assert results[1][0] == {"default/ok": "n0"}
        assert "blocked" in " ".join(results[1][1]["default/nope"])
        # an unknown plugin name fails loudly at framework assembly
        got = both(lambda m: (JScheduler if m is REF else TScheduler)
                   .from_config(m.config_v1alpha1.decode(
                       {"apiVersion": m.config_v1alpha1.GROUP_VERSION,
                        "kind": m.config_v1alpha1.KIND,
                        "plugins": ["NotRegistered"]}),
                       **({} if m is REF else {"device": "cpu"})))
        assert got[:2] == ("error", "ValueError")
        assert "NotRegistered" in got[2]
    finally:
        for m in (REF, PORT):
            m.framework.PLUGIN_REGISTRY.pop("DenyLabeled", None)


@dataclasses.dataclass
class _UnwrapInner:
    a: int = 0


@dataclasses.dataclass
class _OptOuter:
    x: "Optional[_UnwrapInner]" = None


@dataclasses.dataclass
class _PipeOuter:
    x: "_UnwrapInner | None" = None


@pytest.mark.parametrize("outer", [_OptOuter, _PipeOuter])
def test_union_annotations_unwrap_for_strict_build(outer):
    got = both(lambda m: m.scheme._build_dataclass(outer, {"x": {"a": 3}},
                                                   "spec"))
    assert got[1] == ("_OptOuter" if outer is _OptOuter else "_PipeOuter",
                      {"x": ("_UnwrapInner", {"a": 3})})
    got = both(lambda m: m.scheme._build_dataclass(
        outer, {"x": {"bogus": 1}}, "spec"))
    assert got[:2] == ("error", "SchemeError") and "unknown field" in got[2]


@dataclasses.dataclass
class _PodV1:
    doc: dict = dataclasses.field(default_factory=dict)


def test_unstructured_decode_split():
    """decode_unstructured: registered kinds build typed and strict,
    unknown kinds become dict-backed Unstructured, kind-less documents are
    rejected. (The reference's test registers core/v1 Pod through
    ``api/core_v1.new_scheme``, whose converters belong to the serve-loop
    slice; here the same strict holder is registered directly.)"""
    doc = {"apiVersion": "stable.example.com/v1", "kind": "CronTab",
           "metadata": {"name": "my-tab", "namespace": "team-a",
                        "labels": {"app": "x"}},
           "spec": {"cronSpec": "* * * * */5", "replicas": 3}}

    def case(m):
        s = m.scheme.Scheme()
        s.register("v1", "Pod", _PodV1)
        u = m.scheme.decode_unstructured(s, doc)
        assert isinstance(u, m.scheme.Unstructured)
        out = [(u.kind, u.name, u.namespace), u.labels,
               u.get("spec", "replicas"), u.get("spec", "missing", "deep"),
               u.to_doc() == doc]
        for bad in ({"apiVersion": "v1", "kind": "Pod",
                     "metadata": {"name": "p"}, "bogusField": 1},
                    {"metadata": {"name": "x"}}):
            out.append(outcome(lambda b=bad: m.scheme.decode_unstructured(
                s, b))[:2])
        return out

    got = both(case)[1]
    assert got[:5] == [("CronTab", "my-tab", "team-a"), {"app": "x"}, 3,
                       None, True]
    assert got[5:] == [("error", "SchemeError")] * 2


# -- Scheduler.from_config ----------------------------------------------------


def test_from_config_sets_every_argument_the_reference_sets():
    """The constructor arguments both packages derive from one document:
    defaults, a Policy with extenders, and the robustness / warmup /
    truncation blocks."""
    doc = {"apiVersion": "kubescheduler.config.k8s.io/v1alpha1",
           "kind": "KubeSchedulerConfiguration", "schedulerName": "cfg",
           "percentageOfNodesToScore": 50, "perNodeCap": 2,
           "maxBatch": 512, "pipelineDepth": 1,
           "featureGates": {"NonPreemptingPriority": True},
           "robustness": {"cycleDeadline": "2500ms", "solverRetries": 2,
                          "breakerFailureThreshold": 5},
           "warmup": {"enabled": True, "minBucket": 8},
           "algorithmSource": {"policy": {
               "kind": "Policy",
               "predicates": [{"name": "PodFitsResources"}],
               "priorities": [{"name": "LeastRequestedPriority",
                               "weight": 2}],
               "extenders": [{"urlPrefix": "http://127.0.0.1:1/x",
                              "filterVerb": "filter", "weight": 3}]}}}
    from kubernetes_tpu.scheduler import Scheduler as JScheduler
    from kubernetes_tpu_torch.scheduler import Scheduler as TScheduler

    js = JScheduler.from_config(REF.cli.decode_config(doc))
    ts = TScheduler.from_config(PORT.cli.decode_config(doc), device="cpu")
    for attr in ("scheduler_name", "solver", "pred_mask", "weights",
                 "per_node_cap", "max_rounds", "max_batch",
                 "enable_non_preempting", "pipeline_depth",
                 "pipeline_chunk", "percentage_of_nodes_to_score",
                 "robustness", "warmup_config", "incremental",
                 "trace_threshold_s"):
        assert plain(getattr(ts, attr)) == plain(getattr(js, attr)), attr
    assert ([plain(e.config) for e in ts.extenders]
            == [plain(e.config) for e in js.extenders])
    assert ts.explain and ts.explain_top_k == 3


GV = {"apiVersion": "kubescheduler.config.k8s.io/v1alpha1",
      "kind": "KubeSchedulerConfiguration"}


@pytest.mark.parametrize("doc", [
    {"percentageOfNodesToScore": 100},
    {"solver": "sinkhorn", "percentageOfNodesToScore": 100},
    {"percentageOfNodesToScore": 50},
    {"algorithmSource": {"policy": {
        "kind": "Policy",
        "predicates": [{"name": "PodFitsResources"},
                       {"name": "PodToleratesNodeTaints"}],
        "priorities": [{"name": "LeastRequestedPriority", "weight": 1},
                       {"name": "NodeAffinityPriority", "weight": 2}]}}},
], ids=["defaults", "sinkhorn", "truncated", "policy"])
def test_configured_schedulers_drive_like_the_reference(monkeypatch, doc):
    """Both packages' ``from_config`` from one document drive three
    cycles of a seeded cluster to the same tiers, placements, reason
    bits and metric counts."""
    from torch_parity import (
        LADDER_METRICS,
        PIPELINE_FIELDS,
        assert_same_cycle,
        config_pair,
        pref_affinity_cluster,
        to_port,
    )

    # the sinkhorn tier: the reference's Pallas kernels in interpret mode
    monkeypatch.setenv("KTPU_PALLAS", "1")
    nodes, bound, pending = pref_affinity_cluster(4, n_nodes=120,
                                                  n_bound=20, n_pending=90)
    js, ts = config_pair({**GV, **doc, "maxBatch": 32},
                         enable_preemption=False)
    for nd in nodes:
        js.on_node_add(nd)
        ts.on_node_add(to_port(nd))
    for p in bound + pending:
        js.on_pod_add(p)
        ts.on_pod_add(to_port(p))
    for _ in range(3):
        rj, rt = js.schedule_cycle(), ts.schedule_cycle()
        assert_same_cycle(rj, rt, PIPELINE_FIELDS + ("solver_fallbacks",))
        assert rt.solver_tier == (doc.get("solver") or "batch")
    for name in LADDER_METRICS:
        assert (getattr(ts.metrics, name)._values
                == getattr(js.metrics, name)._values), name
    assert ts.percentage_of_nodes_to_score == js.percentage_of_nodes_to_score


def test_metrics_exposition_gives_the_references_names():
    """The port's registry exposes every family of the reference's under
    the same name, type and labels (one more: the round-loop graph
    captures, the port's retrace analog), after the same driven cycle."""
    from torch_parity import config_pair, pref_affinity_cluster, to_port

    nodes, bound, pending = pref_affinity_cluster(6, n_nodes=12, n_bound=4,
                                                  n_pending=10)
    js, ts = config_pair({**GV, "percentageOfNodesToScore": 100},
                         enable_preemption=False)
    for nd in nodes:
        js.on_node_add(nd)
        ts.on_node_add(to_port(nd))
    for p in bound + pending:
        js.on_pod_add(p)
        ts.on_pod_add(to_port(p))
    js.schedule_cycle()
    ts.schedule_cycle()

    def families(text):
        return {tuple(line.split()[2:4]) for line in text.splitlines()
                if line.startswith("# TYPE")}

    got = families(ts.metrics.registry.expose())
    want = families(js.metrics.registry.expose())
    assert got - want == {("scheduler_round_loop_captures_total", "counter")}
    assert want <= got
    for line in js.metrics.registry.expose().splitlines():
        if line.startswith("scheduler_schedule_attempts_total"):
            assert line in ts.metrics.registry.expose().splitlines()
