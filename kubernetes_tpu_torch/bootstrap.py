"""Cluster bootstrap — the kubeadm analog (SURVEY §2.2 "kubeadm:
cluster bootstrap phases"; reference ``cmd/kubeadm/app/cmd/init.go``
phase runner, ``app/phases/``, and the bootstrap-token discovery flow
``app/discovery/token``).

kubeadm's job split into the phases that matter for a hollow control
plane:

- **preflight** — config validation (``app/preflight/checks.go``);
- **control-plane** — bring up the hub (apiserver+etcd analog), the
  controller passes, and the scheduler (one HollowCluster);
- **mark-control-plane** — taint/label the control-plane node
  (``app/phases/markcontrolplane``): workloads don't land there unless
  they tolerate the master taint;
- **bootstrap-token** — mint a ``abcdef.0123456789abcdef`` token with a
  TTL (``app/phases/bootstraptoken/node``);
- **join** — a node presents the token; valid ⇒ its kubelet
  self-registers and starts heartbeating (``app/cmd/join.go``).

``init_cluster``/``join_node`` are the ``kubeadm init``/``kubeadm join``
entry points.
"""

from __future__ import annotations

import dataclasses
import secrets
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.types import (
    EFFECT_NO_SCHEDULE,
    Node,
    Resources,
    Taint,
)
from kubernetes_tpu_torch.sim import HollowCluster

#: the control-plane taint/label pair (markcontrolplane/markcontrolplane.go)
TAINT_CONTROL_PLANE = "node-role.kubernetes.io/master"
LABEL_CONTROL_PLANE = "node-role.kubernetes.io/master"

TOKEN_ID_LEN = 6
TOKEN_SECRET_LEN = 16
_TOKEN_ALPHABET = "abcdefghijklmnopqrstuvwxyz0123456789"


class BootstrapError(Exception):
    """Preflight/validation/discovery failure (kubeadm's fatal errors)."""


@dataclass
class InitConfig:
    """The ClusterConfiguration slice the hollow phases consume
    (app/apis/kubeadm/types.go)."""

    cluster_name: str = "kubernetes"
    control_plane_name: str = "control-plane"
    control_plane_cpu_milli: float = 4000.0
    control_plane_memory: float = 8 * 2**30
    #: token TTL in seconds; 0 = never expires (kubeadm default 24 h)
    token_ttl_s: float = 24 * 3600.0
    #: enable the hub's admission chain (--enable-admission-plugins)
    admission: bool = False
    #: forwarded to HollowCluster (seed, rates, scheduler_kw...)
    hub_kw: Dict = field(default_factory=dict)


@dataclass
class BootstrapToken:
    token_id: str
    secret: str
    created_at: float = 0.0
    ttl_s: float = 0.0
    usages: Tuple[str, ...] = ("authentication", "signing")

    def render(self) -> str:
        return f"{self.token_id}.{self.secret}"

    def expired(self, now: float) -> bool:
        return self.ttl_s > 0 and now - self.created_at > self.ttl_s


def _rand(n: int) -> str:
    return "".join(secrets.choice(_TOKEN_ALPHABET) for _ in range(n))


def preflight(config: InitConfig) -> None:
    """app/preflight/checks.go analog: reject impossible configs before
    any state exists."""
    if not config.cluster_name:
        raise BootstrapError("preflight: cluster_name must be non-empty")
    if not config.control_plane_name:
        raise BootstrapError("preflight: control_plane_name must be non-empty")
    if config.control_plane_cpu_milli <= 0 or config.control_plane_memory <= 0:
        raise BootstrapError("preflight: control-plane resources must be > 0")
    if config.token_ttl_s < 0:
        raise BootstrapError("preflight: token_ttl_s must be >= 0")


def create_token(hub: HollowCluster, ttl_s: float = 24 * 3600.0) -> str:
    """Mint and store a bootstrap token (phases/bootstraptoken)."""
    tok = BootstrapToken(_rand(TOKEN_ID_LEN), _rand(TOKEN_SECRET_LEN),
                         created_at=hub.clock.t, ttl_s=ttl_s)
    hub.bootstrap_tokens[tok.token_id] = tok
    return tok.render()


def init_cluster(config: Optional[InitConfig] = None
                 ) -> Tuple[HollowCluster, str]:
    """``kubeadm init``: run the phases, return the running control plane
    and a join token."""
    config = config or InitConfig()
    preflight(config)
    # control-plane phase: hub (apiserver/etcd/controllers/scheduler)
    hub = HollowCluster(admission=config.admission, **config.hub_kw)
    hub.bootstrap_tokens = {}
    # mark-control-plane: the master node exists, tainted + labeled
    cp = Node(
        config.control_plane_name,
        labels={LABEL_CONTROL_PLANE: ""},
        allocatable=Resources(cpu_milli=config.control_plane_cpu_milli,
                              memory=config.control_plane_memory, pods=110),
        taints=(Taint(TAINT_CONTROL_PLANE, effect=EFFECT_NO_SCHEDULE),),
    )
    hub.add_node(cp)
    # upload-config analog: the config object is readable cluster state
    hub.cluster_config = config
    # bootstrap-token phase
    token = create_token(hub, config.token_ttl_s)
    return hub, token


def join_node(hub: HollowCluster, token: str, node: Node) -> None:
    """``kubeadm join``: token discovery then kubelet self-registration.
    Raises :class:`BootstrapError` on a bad/expired token (the TLS
    bootstrap rejection)."""
    tokens = hub.bootstrap_tokens
    tid, _, secret = token.partition(".")
    tok = tokens.get(tid)
    if tok is None or tok.secret != secret:
        raise BootstrapError("join: unknown or malformed bootstrap token")
    if tok.expired(hub.clock.t):
        del tokens[tid]
        raise BootstrapError("join: bootstrap token expired")
    if node.name in hub.truth_nodes:
        raise BootstrapError(f"join: node {node.name!r} already registered")
    hub.add_node(node)  # kubelet self-registration (ADDED event + agent)


# ---------------------------------------------------------------------------
# Bootstrap-token controllers (pkg/controller/bootstrap)
# ---------------------------------------------------------------------------

#: where the signer publishes discovery state (bootstrapapi constants:
#: the cluster-info ConfigMap in kube-public that `kubeadm join` reads
#: ANONYMOUSLY, verified via a token-keyed detached signature)
KUBE_PUBLIC = "kube-public"
CLUSTER_INFO = "cluster-info"
JWS_PREFIX = "jws-kubeconfig-"


def _detached_signature(token_id: str, secret: str, content: str) -> str:
    """The ComputeDetachedSignature analog (cluster-bootstrap/token/jws):
    an HMAC keyed on the full token over the kubeconfig content —
    possession of EITHER half alone cannot forge it, holding both
    verifies the published CA out-of-band."""
    import hashlib
    import hmac as hmac_mod

    return hmac_mod.new(f"{token_id}.{secret}".encode(), content.encode(),
                        hashlib.sha256).hexdigest()


def token_cleaner(hub: HollowCluster) -> int:
    """TokenCleaner (bootstrap/tokencleaner.go:59): proactively delete
    expired bootstrap tokens — join_node's lazy check only fires when
    someone USES the dead token; this pass revokes it for the
    authenticator too. Returns how many were deleted."""
    dead = [tid for tid, tok in hub.bootstrap_tokens.items()
            if tok.expired(hub.clock.t)]
    for tid in dead:
        del hub.bootstrap_tokens[tid]
    return len(dead)


def bootstrap_signer(hub: HollowCluster) -> None:
    """BootstrapSigner (bootstrap/bootstrapsigner.go:73 signConfigMap):
    maintain the kube-public/cluster-info ConfigMap — the kubeconfig
    (cluster CA + endpoint) plus one ``jws-kubeconfig-<id>`` detached
    signature per SIGNING-usage live token; signatures for gone tokens
    are removed (the reference strips all and recomputes)."""
    kubeconfig = (
        f"apiVersion: v1\nkind: Config\nclusters:\n- cluster:\n"
        f"    certificate-authority-data: {hub.cluster_ca}\n"
        f"    server: https://{getattr(hub, 'cluster_config', None) and hub.cluster_config.control_plane_name or 'control-plane'}:6443\n"
    )
    data = {"kubeconfig": kubeconfig}
    for tid, tok in hub.bootstrap_tokens.items():
        if "signing" not in tok.usages or tok.expired(hub.clock.t):
            continue
        data[f"{JWS_PREFIX}{tid}"] = _detached_signature(
            tid, tok.secret, kubeconfig)
    cur = hub.configmaps.get(f"{KUBE_PUBLIC}/{CLUSTER_INFO}")
    if cur is None or cur.get("data") != data:
        hub.put_configmap(KUBE_PUBLIC, CLUSTER_INFO, data)


def verify_cluster_info(hub: HollowCluster, token: str) -> str:
    """The join-side discovery check (kubeadm token-based discovery:
    fetch cluster-info anonymously, verify the JWS for YOUR token,
    then trust the embedded CA). Returns the verified kubeconfig or
    raises :class:`BootstrapError`."""
    cm = hub.configmaps.get(f"{KUBE_PUBLIC}/{CLUSTER_INFO}")
    if cm is None:
        raise BootstrapError("discovery: cluster-info not published")
    tid, _, secret = token.partition(".")
    kubeconfig = cm["data"].get("kubeconfig", "")
    sig = cm["data"].get(f"{JWS_PREFIX}{tid}")
    if sig is None:
        raise BootstrapError(
            f"discovery: no signature for token id {tid!r}")
    if sig != _detached_signature(tid, secret, kubeconfig):
        raise BootstrapError("discovery: cluster-info signature mismatch")
    return kubeconfig
