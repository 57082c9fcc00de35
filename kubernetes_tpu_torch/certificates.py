"""certificates.k8s.io — CSR approve/sign/clean + root-CA publisher.

The reference's kubelet identity bootstrap is a four-actor flow:

- a node submits a CertificateSigningRequest carrying its requested
  subject (CN ``system:node:<name>``, O ``system:nodes``) under its
  bootstrap identity;
- the approver recognizes the two node-client CSR shapes and approves
  iff a SubjectAccessReview grants the requestor the matching
  ``certificatesigningrequests/{nodeclient,selfnodeclient}`` create
  permission (pkg/controller/certificates/approver/sarapprove.go:58
  recognizers, :74 handle);
- the signer signs approved CSRs and writes status.certificate
  (signer/cfssl_signer.go:117 sign);
- the cleaner garbage-collects finished/stale CSRs
  (cleaner/cleaner.go:40 — signed/denied after 1 h, pending after 24 h).

The TPU-native analog models the credential, not the x509: a "signed
certificate" here is an opaque revocable credential string minted from
the hub's CA secret, registered in a live lookup
(:meth:`HollowCluster.cert_user`) the authn chain consumes exactly like
service-account tokens (auth.ServiceAccountAuthenticator takes any
``credential -> UserInfo`` lookup; TLS client-cert auth is modeled as a
bearer credential on this facade). Expiry is enforced at lookup time —
an expired cert authenticates as nothing, the reference's
NotAfter semantics.

rootcacertpublisher (certificates/rootcacertpublisher/publisher.go):
every Active namespace gets a ``kube-root-ca.crt`` ConfigMap carrying
the cluster CA bundle, recreated if deleted, removed with the
namespace.
"""

from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from kubernetes_tpu_torch.auth import (
    ALLOW,
    Attributes,
    Rule,
    RuleAuthorizer,
    UserInfo,
)

NODE_USER_PREFIX = "system:node:"
NODES_GROUP = "system:nodes"
BOOTSTRAPPERS_GROUP = "system:bootstrappers"

#: the exact usage set a kubelet client cert requests — any other set is
#: NOT a node-client CSR (certificate_controller_utils.go
#: IsKubeletClientCSR / kubeletClientUsages)
NODE_CLIENT_USAGES = frozenset(
    {"key encipherment", "digital signature", "client auth"})

ROOT_CA_CONFIGMAP = "kube-root-ca.crt"


@dataclass
class CertificateSigningRequest:
    """The certificates.k8s.io/v1beta1 slice the controllers consume:
    requestor identity (spec.username/groups), the requested subject
    (the parsed CSR's CN/O — we carry them as fields instead of a PEM
    blob), usages, and the approval/signing status."""

    name: str
    #: spec.username/groups — the authenticated identity that CREATED
    #: the CSR (stamped by the apiserver, not client-controlled)
    username: str = ""
    groups: Tuple[str, ...] = ()
    #: requested subject: CommonName + Organizations of the inner CSR
    request_cn: str = ""
    request_orgs: Tuple[str, ...] = ()
    usages: Tuple[str, ...] = tuple(sorted(NODE_CLIENT_USAGES))
    #: approval condition: None = pending, True = Approved, False = Denied
    approved: Optional[bool] = None
    approval_message: str = ""
    #: when the approval condition landed (the condition timestamp the
    #: cleaner keys denied-CSR age on — cleaner.go isDeniedExpired)
    decided_at: Optional[float] = None
    #: status.certificate — the minted credential (empty until signed)
    certificate: str = ""
    created_at: float = 0.0
    signed_at: float = 0.0


def node_bootstrap_csr(node_name: str, username: str = "",
                       groups: Tuple[str, ...] = (BOOTSTRAPPERS_GROUP,),
                       ) -> CertificateSigningRequest:
    """The CSR a kubelet's TLS bootstrap submits (kubeadm join path):
    subject ``system:node:<name>`` / O ``system:nodes`` under the
    bootstrap-token identity; with ``username=system:node:<name>`` and
    the nodes group it is the self-renewal shape instead."""
    return CertificateSigningRequest(
        name=f"csr-{node_name}",
        username=username or f"{BOOTSTRAPPERS_GROUP}:{node_name}",
        groups=groups,
        request_cn=f"{NODE_USER_PREFIX}{node_name}",
        request_orgs=(NODES_GROUP,),
    )


def is_node_client_csr(csr: CertificateSigningRequest) -> bool:
    """sarapprove.go isNodeClientCert: O == [system:nodes], CN has the
    node prefix, and usages are exactly the kubelet-client set."""
    return (tuple(csr.request_orgs) == (NODES_GROUP,)
            and csr.request_cn.startswith(NODE_USER_PREFIX)
            and frozenset(csr.usages) == NODE_CLIENT_USAGES)


def is_self_node_client_csr(csr: CertificateSigningRequest) -> bool:
    """sarapprove.go isSelfNodeClientCert: a node-client CSR whose
    requestor already IS that node (renewal)."""
    return is_node_client_csr(csr) and csr.username == csr.request_cn


def kubeadm_default_csr_authorizer() -> RuleAuthorizer:
    """The two RBAC bindings kubeadm installs for the bootstrap flow
    (bootstrap-tokens phase): bootstrappers may create nodeclient CSRs,
    nodes may renew their own (selfnodeclient). Resource is spelled
    ``certificatesigningrequests/<subresource>`` — the facade's
    Attributes has no subresource field, so the SAR permission rides
    the resource string."""
    return RuleAuthorizer([
        Rule(subjects=(BOOTSTRAPPERS_GROUP,), verbs=("create",),
             resources=("certificatesigningrequests/nodeclient",)),
        Rule(subjects=(NODES_GROUP,), verbs=("create",),
             resources=("certificatesigningrequests/selfnodeclient",)),
    ])


class CertificateController:
    """Approver + signer + cleaner in one reconcile pass (the reference
    runs them as three controllers over one informer; the hub's
    controller-manager tick drives all three in CSR-name order so the
    flow is deterministic under the fuzz harness)."""

    def __init__(self, hub, authorizer=None,
                 cert_duration_s: float = 365 * 24 * 3600.0,
                 signed_ttl_s: float = 3600.0,
                 pending_ttl_s: float = 24 * 3600.0) -> None:
        self.hub = hub
        self.authorizer = authorizer or kubeadm_default_csr_authorizer()
        self.cert_duration_s = cert_duration_s
        self.signed_ttl_s = signed_ttl_s
        self.pending_ttl_s = pending_ttl_s
        self.approved_total = 0
        self.denied_ignored_total = 0
        self.signed_total = 0
        self.cleaned_total = 0

    # -- approver ----------------------------------------------------------

    def _approve(self, csr: CertificateSigningRequest) -> None:
        """sarapprove.go:74 handle: skip signed/decided CSRs; recognize,
        then authorize the REQUESTOR (not the subject) against the
        recognizer's permission. Unrecognized CSRs are left pending —
        the reference never auto-denies, a human or another approver
        may still act."""
        if csr.certificate or csr.approved is not None:
            return
        recognized = (
            ("selfnodeclient", is_self_node_client_csr),
            ("nodeclient", is_node_client_csr),
        )
        user = UserInfo(name=csr.username, groups=tuple(csr.groups))
        for subresource, recognize in recognized:
            if not recognize(csr):
                continue
            a = Attributes(
                user=user, verb="create",
                resource=f"certificatesigningrequests/{subresource}",
                namespace="", name=csr.name, path="")
            if self.authorizer.authorize(a) == ALLOW:
                csr.approved = True
                csr.decided_at = self.hub.clock.t
                csr.approval_message = (
                    "Auto approving kubelet client certificate after "
                    "SubjectAccessReview.")
                self.approved_total += 1
                self.hub._commit(f"certificatesigningrequests/{csr.name}",
                                 "MODIFIED", csr)
                # CSRs are cluster-scoped: empty namespace segment (the
                # reference's involvedObject.namespace is "" here)
                self.hub.record_controller_event(
                    "CSRApproved", f"/{csr.name}",
                    csr.approval_message,
                    involved_kind="CertificateSigningRequest")
                return
            self.denied_ignored_total += 1

    # -- signer ------------------------------------------------------------

    def _sign(self, csr: CertificateSigningRequest) -> None:
        """cfssl_signer.go:117: approved + unsigned -> mint the
        credential and register it in the hub's live cert registry with
        its NotAfter."""
        if not csr.approved or csr.certificate:
            return
        hub = self.hub
        digest = hashlib.sha256(
            f"{hub.cluster_ca}|{csr.name}|{csr.request_cn}|"
            f"{hub._revision}".encode()).hexdigest()[:32]
        csr.certificate = f"nodecert:{csr.request_cn}:{digest}"
        csr.signed_at = hub.clock.t
        hub.signed_certs[csr.certificate] = (
            UserInfo(name=csr.request_cn, groups=tuple(csr.request_orgs)),
            hub.clock.t + self.cert_duration_s,
        )
        self.signed_total += 1
        hub._commit(f"certificatesigningrequests/{csr.name}",
                    "MODIFIED", csr)

    # -- cleaner -----------------------------------------------------------

    def _clean(self, csr: CertificateSigningRequest) -> bool:
        """cleaner.go:40 pollers: signed or denied CSR objects age out
        after 1 h, never-decided ones after 24 h. Cleaning deletes the
        CSR OBJECT only — the minted credential lives until expiry
        (the reference's issued certs likewise outlive their CSRs)."""
        now = self.hub.clock.t
        if csr.certificate or csr.approved is False:
            ref = (csr.signed_at if csr.certificate
                   else csr.decided_at if csr.decided_at is not None
                   else csr.created_at)
            return now - ref >= self.signed_ttl_s
        return now - csr.created_at >= self.pending_ttl_s

    def reconcile(self) -> None:
        hub = self.hub
        for name in sorted(hub.csrs):
            csr = hub.csrs[name]
            if csr.approved is not None and csr.decided_at is None:
                # externally-decided CSR (a test or operator flipped the
                # condition directly): stamp the condition time now so
                # the cleaner's TTL runs from the DECISION, not create —
                # a denial is observable for its full signed_ttl window
                csr.decided_at = hub.clock.t
            self._approve(csr)
            self._sign(csr)
            if self._clean(csr):
                del hub.csrs[name]
                self.cleaned_total += 1
                hub._commit(f"certificatesigningrequests/{name}",
                            "DELETED", None)
        # expired credentials leave the live registry (NotAfter)
        for cert in [c for c, (_, exp) in hub.signed_certs.items()
                     if hub.clock.t >= exp]:
            del hub.signed_certs[cert]


class RootCACertPublisher:
    """rootcacertpublisher/publisher.go: every Active namespace carries
    the cluster CA bundle in a ``kube-root-ca.crt`` ConfigMap so
    in-cluster clients can verify the apiserver; recreated when
    deleted/mutated, torn down with the namespace (the namespace
    drain owns that half)."""

    def __init__(self, hub) -> None:
        self.hub = hub
        self.writes_total = 0

    def reconcile(self) -> None:
        hub = self.hub
        from kubernetes_tpu_torch.sim import NS_ACTIVE

        for ns_name, ns in hub.namespaces.items():
            if ns.phase != NS_ACTIVE:
                continue
            key = f"{ns_name}/{ROOT_CA_CONFIGMAP}"
            cm = hub.configmaps.get(key)
            want = {"ca.crt": hub.cluster_ca}
            if cm is None or cm.get("data") != want:
                hub.put_configmap(ns_name, ROOT_CA_CONFIGMAP, want)
                self.writes_total += 1
