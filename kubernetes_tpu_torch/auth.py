"""Authentication and authorization for the REST facade.

The reference fronts every apiserver request with a filter chain in a
fixed order — authentication, then authorization, then admission
(staging/src/k8s.io/apiserver/pkg/endpoints/filters/authentication.go:41
WithAuthentication, authorization.go:42 WithAuthorization; chain assembly
in pkg/server/config.go:639 DefaultBuildHandlerChain).  This module is
that chain's TPU-framework analog, sized to the hollow control plane:

- :class:`TokenAuthenticator` — the static bearer-token table
  (plugin/pkg/authenticator/token/tokenfile/tokenfile.go:48): maps
  ``Authorization: Bearer <token>`` to a :class:`UserInfo`.  Unknown
  token => 401.  Absent credentials fall through to the anonymous user
  ``system:anonymous`` in group ``system:unauthenticated`` when
  ``anonymous`` is on (pkg/authentication/request/anonymous/anonymous.go:30),
  else 401.
- :class:`RuleAuthorizer` — an RBAC-lite rule list: each
  :class:`Rule` names subjects (users and/or groups) and the
  verbs/resources/namespaces they may touch, "*" wildcards allowed
  (the shape of rbac/v1 PolicyRule, plugin/pkg/auth/authorizer/rbac/rbac.go:79
  RuleAllows).  First matching rule allows; no match => deny
  (RBAC is allow-only, deny is the absence of a grant).
- :class:`AlwaysAllow` / :class:`AlwaysDeny` — the trivial authorizers
  (pkg/auth/authorizer/abac ... authorizerfactory/builtin.go:26).
- :func:`chain` — union of authorizers: first non-NO_OPINION decision
  wins (pkg/authorization/union/union.go:47).

The REST server (restapi.py) runs authenticate -> authorize before any
handler logic, returns Status-shaped 401/403, and stamps the resolved
identity into the audit entry (the reference's audit events carry
``user.username`` the same way — apis/audit/types.go Event.User).
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Optional, Sequence

ALLOW = "allow"
DENY = "deny"
NO_OPINION = "no-opinion"


class UserInfo(NamedTuple):
    """user.Info (staging/src/k8s.io/apiserver/pkg/authentication/user/user.go:20)."""

    name: str
    groups: tuple = ()
    uid: str = ""


ANONYMOUS = UserInfo(name="system:anonymous",
                     groups=("system:unauthenticated",))


class Unauthenticated(Exception):
    """Raised by an authenticator for a request that presented invalid
    credentials (distinct from presenting none: invalid never falls
    through to anonymous — authentication.go:50 'if err != nil ...401')."""


def _parse_bearer(headers) -> Optional[str]:
    """The ONE bearer-header parse both authenticators share: the token
    string, or None for credential-less/non-Bearer/empty (NO OPINION —
    bearertoken.go:30 returns nil,false,nil; such requests fall through
    to anonymous/fallback policy, they are not failures)."""
    raw = headers.get("Authorization", "") if headers else ""
    parts = raw.split(None, 1)
    if (not raw or len(parts) != 2 or parts[0].lower() != "bearer"
            or not parts[1].strip()):
        return None
    return parts[1].strip()


class TokenAuthenticator:
    """Static token table: ``{token: UserInfo}``.

    ``authenticate(headers)`` returns the matched user, the anonymous
    user (when enabled) for credential-less requests, or raises
    :class:`Unauthenticated` for a malformed/unknown token."""

    def __init__(self, tokens: dict, anonymous: bool = False) -> None:
        for t, u in tokens.items():
            if not isinstance(u, UserInfo):
                raise TypeError(f"token {t!r} must map to UserInfo, got {u!r}")
        self.tokens = dict(tokens)
        self.anonymous = anonymous

    def authenticate(self, headers) -> UserInfo:
        token = _parse_bearer(headers)
        if token is None:
            if self.anonymous:
                return ANONYMOUS
            raise Unauthenticated("no credentials provided")
        user = self.tokens.get(token)
        if user is None:
            # a PRESENT-but-unknown bearer token is a hard failure and
            # never becomes anonymous (bearertoken.go:41 invalid token)
            raise Unauthenticated("invalid bearer token")
        return user


#: the reference's service-account identity shape
#: (serviceaccount/util.go MakeUsername / MakeGroupNames)
SA_USER_PREFIX = "system:serviceaccount:"
SA_GROUP_ALL = "system:serviceaccounts"
SA_GROUP_NS_PREFIX = "system:serviceaccounts:"


def service_account_user(namespace: str, name: str) -> UserInfo:
    """UserInfo for a pod/service-account identity:
    ``system:serviceaccount:<ns>:<name>`` in the all-SAs group and the
    per-namespace group — the exact triple RBAC bindings key on."""
    return UserInfo(
        name=f"{SA_USER_PREFIX}{namespace}:{name}",
        groups=(SA_GROUP_ALL, f"{SA_GROUP_NS_PREFIX}{namespace}"),
    )


class ServiceAccountAuthenticator:
    """Bearer-token authenticator over a LIVE token registry — the
    consumer half of the tokens controller
    (pkg/controller/serviceaccount/tokens_controller.go:73 mints; the
    serviceaccount token authenticator validates). ``lookup`` is a
    callable ``token -> UserInfo | None`` (the hub's revocable registry:
    a deleted namespace revokes its tokens, and this authenticator sees
    that immediately — no static table to go stale).

    Composable: an unknown token consults ``fallback`` (another
    authenticator, e.g. the static TokenAuthenticator for operator
    tokens) before failing; credential-less requests delegate to the
    fallback's anonymous policy, or honor ``anonymous`` here."""

    def __init__(self, lookup, fallback=None, anonymous: bool = False):
        self.lookup = lookup
        self.fallback = fallback
        self.anonymous = anonymous

    def authenticate(self, headers) -> UserInfo:
        token = _parse_bearer(headers)
        if token is None:
            if self.fallback is not None:
                return self.fallback.authenticate(headers)
            if self.anonymous:
                return ANONYMOUS
            raise Unauthenticated("no credentials provided")
        user = self.lookup(token)
        if user is not None:
            return user
        if self.fallback is not None:
            return self.fallback.authenticate(headers)
        raise Unauthenticated("invalid bearer token")


class ServiceAccountNamespaceAuthorizer:
    """RBAC-lite per-namespace binding for EVERY service account: the
    identity minted for namespace X may touch resources ONLY in
    namespace X (the edit-role-per-namespace binding the tokens
    controller implies; a pod-identity token authorizes exactly its
    namespace). Cluster-scoped and non-resource requests are
    NO_OPINION — chain an explicit rule list for those."""

    def __init__(self, verbs: tuple = ("get", "list", "watch", "create",
                                       "update", "patch", "delete")):
        self.verbs = tuple(verbs)

    def authorize(self, a: "Attributes") -> str:
        if not a.resource or not a.namespace:
            return NO_OPINION
        if a.verb not in self.verbs:
            return NO_OPINION
        for g in a.user.groups:
            if (g.startswith(SA_GROUP_NS_PREFIX)
                    and g[len(SA_GROUP_NS_PREFIX):] == a.namespace):
                return ALLOW
        return NO_OPINION


class Attributes(NamedTuple):
    """authorizer.Attributes (authorization/authorizer/interfaces.go:28):
    who is doing what to which resource. A NON-resource request
    (discovery, /openapi/v2, /version — IsResourceRequest false) carries
    ``resource=""`` and the raw ``path`` instead, matched by a Rule's
    ``non_resource_urls`` the way RBAC's NonResourceURLs work."""

    user: UserInfo
    verb: str  # get/list/watch/create/update/delete
    resource: str  # pods/nodes/bindings/...; "" = non-resource request
    namespace: str = ""
    name: str = ""
    path: str = ""  # non-resource URL (set iff resource == "")


class Rule(NamedTuple):
    """One allow-rule. Empty/"*" entries are wildcards. ``subjects``
    match either the username or any group the user carries.
    ``non_resource_urls`` grants NON-resource paths (rbac/v1
    PolicyRule.NonResourceURLs, matched by rbac.go:170
    NonResourceURLMatches): exact paths or a trailing-``*`` prefix like
    ``"/api/*"`` — a rule with them set matches ONLY non-resource
    requests, and resource rules never match non-resource requests
    (``resources=("*",)`` still means every RESOURCE, not discovery)."""

    subjects: tuple  # usernames and/or group names
    verbs: tuple = ("*",)
    resources: tuple = ("*",)
    namespaces: tuple = ("*",)
    non_resource_urls: tuple = ()

    def matches(self, a: Attributes) -> bool:
        subj = set(self.subjects)
        if "*" not in subj and a.user.name not in subj and not (
                subj & set(a.user.groups)):
            return False

        def hit(allowed: tuple, value: str) -> bool:
            return "*" in allowed or value in allowed

        if not hit(self.verbs, a.verb):
            return False
        if not a.resource:  # non-resource request: only URL rules apply
            return any(
                a.path == pat or (pat.endswith("*")
                                  and a.path.startswith(pat[:-1]))
                for pat in self.non_resource_urls
            )
        if self.non_resource_urls:
            return False  # URL rules never grant resource requests
        return (hit(self.resources, a.resource)
                and hit(self.namespaces, a.namespace))


class RuleAuthorizer:
    """Allow iff any rule matches; otherwise NO_OPINION so a chain can
    consult the next authorizer (rbac.go:79 — RBAC never denies, it
    just fails to allow)."""

    def __init__(self, rules: Iterable[Rule]) -> None:
        self.rules = tuple(rules)

    def authorize(self, a: Attributes) -> str:
        return ALLOW if any(r.matches(a) for r in self.rules) else NO_OPINION


class AlwaysAllow:
    def authorize(self, a: Attributes) -> str:
        return ALLOW


class AlwaysDeny:
    def authorize(self, a: Attributes) -> str:
        return DENY


class _Union:
    def __init__(self, members: Sequence) -> None:
        self.members = tuple(members)

    def authorize(self, a: Attributes) -> str:
        for m in self.members:
            d = m.authorize(a)
            if d != NO_OPINION:
                return d
        return NO_OPINION


def chain(*authorizers) -> _Union:
    """Union authorizer: first ALLOW or DENY wins; all-NO_OPINION is a
    deny at the filter (union/union.go:47 + authorization.go:64)."""
    return _Union(authorizers)


def forbidden_message(a: Attributes) -> str:
    """The reference's 403 message shape (responsewriters/errors.go:29):
    'User \"x\" cannot create resource \"pods\" in namespace \"ns\"';
    non-resource requests name the path instead."""
    if not a.resource:
        return f'User "{a.user.name}" cannot {a.verb} path "{a.path}"'
    where = (f' in namespace "{a.namespace}"' if a.namespace
             else " at the cluster scope")
    return (f'User "{a.user.name}" cannot {a.verb} resource '
            f'"{a.resource}"{where}')


# ---------------------------------------------------------------------------
# rbac.authorization.k8s.io role/binding model + aggregation
# ---------------------------------------------------------------------------


class PolicyRule(NamedTuple):
    """rbac/v1 PolicyRule — subject-LESS (who is the binding's job,
    unlike this module's flat :class:`Rule` which couples both; the
    role/binding split is what makes aggregation meaningful)."""

    verbs: tuple = ("*",)
    resources: tuple = ("*",)
    namespaces: tuple = ("*",)
    non_resource_urls: tuple = ()

    def grants(self, a: Attributes) -> bool:
        def hit(allowed: tuple, value: str) -> bool:
            return "*" in allowed or value in allowed

        if not hit(self.verbs, a.verb):
            return False
        if not a.resource:
            return any(
                a.path == pat or (pat.endswith("*")
                                  and a.path.startswith(pat[:-1]))
                for pat in self.non_resource_urls
            )
        if self.non_resource_urls:
            return False
        return (hit(self.resources, a.resource)
                and hit(self.namespaces, a.namespace or "*"))


class ClusterRole:
    """rbac/v1 ClusterRole: named rule set, optionally AGGREGATED — when
    ``aggregation_selectors`` is set, the aggregation controller
    overwrites ``rules`` with the union of every other role matching
    any selector (clusterroleaggregation_controller.go:76
    syncClusterRole; the admin/edit/view stack is built this way)."""

    def __init__(self, name, rules=(), labels=None,
                 aggregation_selectors=()):
        self.name = name
        self.rules = tuple(rules)
        self.labels = dict(labels or {})
        #: each selector is a {label: value} dict (AND of pairs; the
        #: reference's LabelSelectorAsSelector matchLabels form)
        self.aggregation_selectors = tuple(
            dict(s) for s in aggregation_selectors)


class ClusterRoleBinding(NamedTuple):
    """rbac/v1 ClusterRoleBinding: subjects -> one role by name."""

    role: str
    subjects: tuple  # usernames and/or group names


class RBACAuthorizer:
    """The role/binding resolver (rbac.go RBACAuthorizer): a request is
    allowed iff some binding covers the user AND its role (with
    aggregated rules already materialized by the controller) grants the
    attributes. Reads LIVE role/binding dicts — pass the hub's."""

    def __init__(self, roles, bindings) -> None:
        self.roles = roles          # name -> ClusterRole (live dict)
        self.bindings = bindings    # list of ClusterRoleBinding (live)

    def authorize(self, a: Attributes) -> str:
        names = {a.user.name, *a.user.groups}
        for b in self.bindings:
            if "*" not in b.subjects and not (names & set(b.subjects)):
                continue
            role = self.roles.get(b.role)
            if role is not None and any(r.grants(a) for r in role.rules):
                return ALLOW
        return NO_OPINION


def aggregate_cluster_roles(roles) -> int:
    """Aggregation to FIXPOINT (clusterroleaggregation_controller.go:76
    syncClusterRole; the reference converges via re-enqueues on every
    role write — one call here runs passes until nothing changes, so
    CHAINED aggregation like view→edit→admin resolves regardless of
    name order). Each pass: for every role with an aggregation rule,
    rules := union (by-name order, self excluded, deduped preserving
    order) of matching roles' rules. Returns how many role updates
    happened across all passes (0 = already settled). Unions only ever
    grow within a call, so the fixpoint exists even with selector
    cycles; the pass bound is a backstop, not a truncation."""
    total = 0
    for _ in range(max(1, len(roles))):
        changed = 0
        for name in sorted(roles):
            role = roles[name]
            if not role.aggregation_selectors:
                continue
            new_rules = []
            for other_name in sorted(roles):
                if other_name == name:
                    continue
                other = roles[other_name]
                if not any(all(other.labels.get(k) == v
                               for k, v in sel.items())
                           for sel in role.aggregation_selectors):
                    continue
                for r in other.rules:
                    if r not in new_rules:
                        new_rules.append(r)
            if tuple(new_rules) != role.rules:
                role.rules = tuple(new_rules)
                changed += 1
        total += changed
        if not changed:
            break
    return total
