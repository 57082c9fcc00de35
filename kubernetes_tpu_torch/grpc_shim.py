"""gRPC streaming shim — the integration seam: a gRPC service speaking
extender-shaped messages (api/types.go:284-330) with a bidirectional
snapshot-delta stream so the node cache stays resident service-side
(nodeCacheCapable semantics, ExtenderConfig api/types.go:203).

Transport layering: where the HTTP webhook seam (extender.py / server.py
ExtenderServer) re-sends state per request, this seam is level-triggered
like the control plane itself — the client streams watch deltas
(SyncState), the service applies them to the scheduler's cache and acks
with the applied revision (the resume point, mirroring watch bookmarks),
and Filter/Prioritize then travel with node NAMES only.

The port of ``kubernetes_tpu/grpc_shim.py``. Its messages are the port's
own proto3 codec (``proto/extender.py``, ``proto/corev1.py``), whose bytes
equal the protobuf runtime's, so a port client talks to a JAX-package
server and the other way round. Only the HTTP/2 transport needs
``grpcio``: it is imported where a server or a channel is made
(:func:`serve_grpc`, :func:`_handlers`, :class:`GrpcSchedulerClient`) and
raises ``ImportError`` naming it where it is absent. The service, the
bridge and :data:`METHODS` (every verb's message classes) need nothing
beyond the port, so another transport can carry the same bytes.
"""

from __future__ import annotations

import json
import threading
from concurrent import futures
from typing import Iterator

from kubernetes_tpu_torch.api.protobuf import (
    node_from_pb,
    node_to_pb,
    pod_from_pb,
    pod_to_pb,
)
from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.extender import (  # noqa: F401 (re-exported)
    node_from_json,
    node_to_json,
    pod_to_json,
)
from kubernetes_tpu_torch.proto import corev1
from kubernetes_tpu_torch.proto import extender as pb
from kubernetes_tpu_torch.server import ExtenderServer, pod_from_json

SERVICE_NAME = "ktpu.TpuScheduler"

#: the largest message either end of the port's seam sends or takes.
#: grpc's default receive limit is 4 MiB, which one GetState of a
#: 5000-node cluster already outgrows (4.9 MB of JSON documents with
#: 5160 pods), as does the first SyncState list of a large enough one;
#: the JAX package keeps the default and answers RESOURCE_EXHAUSTED
MAX_MESSAGE_BYTES = 256 * 2**20
_CHANNEL_OPTIONS = [("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
                    ("grpc.max_send_message_length", MAX_MESSAGE_BYTES)]

#: verb -> (streaming, service method, request class, response class):
#: the one table the server's handlers, the client's stubs and any other
#: transport read their serializers from
METHODS = {
    "SyncState": (True, "sync_state", pb.SnapshotDelta, pb.SyncAck),
    "Filter": (False, "filter", pb.ExtenderArgs, pb.ExtenderFilterResult),
    "Prioritize": (False, "prioritize", pb.ExtenderArgs,
                   pb.HostPriorityList),
    "Bind": (False, "bind", pb.Binding, pb.BindResult),
    "GetState": (False, "get_state", pb.StateRequest, pb.StateSnapshot),
}


def _import_grpc():
    """``grpc``, or ImportError naming ``grpcio``: the seam never falls
    back to another transport."""
    try:
        import grpc
    except ImportError as e:
        raise ImportError(
            "grpcio is not installed: the gRPC transport of the scheduler "
            "seam needs it (the message codec, the service and the delta "
            "bridge do not)") from e
    return grpc


class TpuSchedulerService:
    """Service implementation over a live Scheduler (its cache is the
    resident snapshot the deltas feed)."""

    def __init__(self, scheduler, fault_injector=None) -> None:
        self.scheduler = scheduler
        self.extender = ExtenderServer(scheduler)
        #: deltas serialize against verbs; a service-side cycle loop must
        #: hold this too (sync_state mutates the same cache/queue)
        self.lock = threading.Lock()
        self.revision = 0
        #: chaos seam (kubernetes_tpu_torch/faults.py): fires per served
        #: verb ("grpc-service:filter", ...) — a raising fault rides the
        #: verb's error-result path, simulating a crashing service
        self.fault_injector = fault_injector

    # -- SyncState (bidi stream) -------------------------------------------

    def sync_state(self, request_iterator: Iterator[pb.SnapshotDelta],
                   context) -> Iterator[pb.SyncAck]:
        s = self.scheduler
        for delta in request_iterator:
            with self.lock:
                for nd in delta.nodes:
                    if nd.op == pb.NodeDelta.REMOVE:
                        s.on_node_delete(nd.name)
                    else:
                        if nd.node_pb:
                            node = node_from_pb(
                                corev1.NodeMsg.FromString(nd.node_pb))
                        else:
                            node = node_from_json(json.loads(nd.node_json))
                        if nd.op == pb.NodeDelta.ADD:
                            s.on_node_add(node)
                        else:
                            s.on_node_update(node)
                for pd in delta.pods:
                    if pd.op == pb.PodDelta.REMOVE:
                        known = s.cache.pod(pd.key) or s.queue.pod(pd.key)
                        if known is None:  # unseen key: synthesize for cleanup
                            ns, _, name = pd.key.partition("/")
                            known = Pod(name=name, namespace=ns)
                        s.on_pod_delete(known)
                    else:
                        if pd.pod_pb:
                            pod = pod_from_pb(
                                corev1.PodMsg.FromString(pd.pod_pb))
                        else:
                            pod = pod_from_json(json.loads(pd.pod_json))
                        known = s.cache.pod(pd.key) or s.queue.pod(pd.key)
                        if known is not None:
                            # the UPDATE path owns the queue-removal /
                            # assumption-confirm / Permit-wait invariants
                            # (scheduler.py on_pod_update) — routing
                            # updates through on_pod_add would double-book
                            # a bound pod's capacity
                            s.on_pod_update(known, pod)
                        else:
                            s.on_pod_add(pod)
                self.revision = max(self.revision, delta.revision)
                n_nodes = s.cache.node_count()
                # snapshot while still locked: acking a revision some
                # OTHER stream advanced to would claim deltas this
                # stream never applied
                ack_rev = self.revision
            yield pb.SyncAck(revision=ack_rev,
                             nodes_in_snapshot=n_nodes)

    # -- unary verbs --------------------------------------------------------

    def filter(self, request: pb.ExtenderArgs,
               context) -> pb.ExtenderFilterResult:
        with self.lock:
            payload = {"pod": json.loads(request.pod_json)}
            if request.node_names:
                payload["nodenames"] = list(request.node_names)
            try:
                kind = None
                if self.fault_injector is not None:
                    kind = self.fault_injector.transport_fault(
                        "grpc-service:filter")
                r = self.extender.handle("filter", payload)
                if kind is not None:
                    # the armed corruption poisons the response; a
                    # corrupted shape then fails result construction
                    # below and rides the error-result path like any
                    # remote failure
                    r = self.fault_injector.corrupt_response(kind, r)
                result = pb.ExtenderFilterResult(
                    node_names=r.get("nodenames") or [],
                    failed_nodes=r.get("failedNodes") or {},
                    error=r.get("error", ""),
                )
            except Exception as e:  # verb errors ride the result message
                return pb.ExtenderFilterResult(error=str(e))
        return result

    def prioritize(self, request: pb.ExtenderArgs,
                   context) -> pb.HostPriorityList:
        with self.lock:
            payload = {"pod": json.loads(request.pod_json)}
            if request.node_names:
                payload["nodenames"] = list(request.node_names)
            try:
                kind = None
                if self.fault_injector is not None:
                    kind = self.fault_injector.transport_fault(
                        "grpc-service:prioritize")
                r = self.extender.handle("prioritize", payload)
                if kind is not None:
                    # as above: apply the corruption; a mistyped payload
                    # fails the item loop and becomes the verb's error
                    # result
                    r = self.fault_injector.corrupt_response(kind, r)
                out = pb.HostPriorityList()
                for item in r:
                    out.items.add(host=item["host"], score=item["score"])
            except Exception as e:
                return pb.HostPriorityList(error=str(e))
        return out

    def get_state(self, request: pb.StateRequest,
                  context) -> pb.StateSnapshot:
        """Read-only snapshot dump for tooling (the kubectl read verbs'
        source): cache nodes, bound/assumed pods, queued pods."""
        s = self.scheduler
        with self.lock:
            out = pb.StateSnapshot(revision=self.revision)
            if request.kind in ("", "nodes"):
                for nd in s.cache.nodes():
                    out.node_json.append(json.dumps(node_to_json(nd)))
            if request.kind in ("", "pods"):
                for nd in s.cache.nodes():
                    for p in s.cache.pods_on(nd.name):
                        out.pod_json.append(json.dumps(pod_to_json(p)))
                for qname, pods in s.queue.pending_pods().items():
                    for p in pods:
                        out.pending_json.append(json.dumps(
                            {"queue": qname, "pod": pod_to_json(p)}
                        ))
        return out

    def bind(self, request: pb.Binding, context) -> pb.BindResult:
        """The Binding-subresource write (BindingREST.Create → assignPod,
        registry/core/pod/storage/storage.go:154): a pending pod moves
        from the queue into the cache bound to the target node."""
        s = self.scheduler
        with self.lock:
            key = request.pod_key
            if s.cache.pod(key) is not None:
                return pb.BindResult(ok=False,
                                     error=f"pod {key!r} already bound")
            pod = s.queue.pod(key)
            if pod is None:
                return pb.BindResult(ok=False,
                                     error=f"pod {key!r} not in snapshot")
            try:
                s.queue.delete(key)
                s.cache.assume_pod(pod, request.node)
            except Exception as e:
                s.queue.add(pod)
                return pb.BindResult(ok=False, error=str(e))
        # the binder may be a real network hop (the chaos harness wraps
        # it in injected latency/timeouts) — holding the service lock
        # across it would stall every other verb for the round trip.
        # The ASSUME above already reserves the pod optimistically
        # (scheduler.go's assume-then-bind design), so concurrent binds
        # of the same key fail the cache.pod() check either way.
        try:
            s.binder.bind(pod, request.node)
            with self.lock:
                s.cache.finish_binding(key)
        except Exception as e:
            with self.lock:
                try:
                    s.cache.forget_pod(key)
                except Exception:
                    pass
                # bind failure re-queues (scheduler.go:447 error path) —
                # dropping the pod from both queue and cache would strand
                # it until the client re-sends an ADD delta
                s.queue.add(pod)
            return pb.BindResult(ok=False, error=str(e))
        return pb.BindResult(ok=True, error="")


def _authed(fn, token, denied):
    """Bearer-token gate for one RPC behavior — the wire seam's analog of
    the REST facade's WithAuthentication filter. The check runs eagerly
    at call time, BEFORE any stream generator is returned, so streaming
    RPCs reject as early as unary ones; a refused call aborts with status
    ``denied`` (grpc's UNAUTHENTICATED). A falsy token (None or "") keeps
    the seam open on BOTH sides — an unset env var must not produce a
    server demanding the empty bearer string.

    ``token`` may also be a CALLABLE ``raw_token -> bool`` — a live
    validator (e.g. the hub's service-account token registry,
    ``HollowCluster.sa_token_user``), so the gRPC seam consumes the same
    revocable identities the REST chain does."""
    import hmac

    if not token:
        return fn

    if callable(token):
        def check(request_or_iterator, context):
            md = dict(context.invocation_metadata())
            raw = md.get("authorization", "")
            ok = raw.startswith("Bearer ") and token(raw[len("Bearer "):])
            if not ok:
                context.abort(denied, "invalid bearer token")
            return fn(request_or_iterator, context)

        return check

    want = f"Bearer {token}"

    def check(request_or_iterator, context):
        md = dict(context.invocation_metadata())
        # constant-time compare: this IS the authentication filter
        if not hmac.compare_digest(md.get("authorization", ""), want):
            context.abort(denied, "invalid bearer token")
        return fn(request_or_iterator, context)

    return check


def _handlers(svc: TpuSchedulerService, token=None):
    """The service's ``grpc.GenericRpcHandler``: every verb of
    :data:`METHODS` behind the token gate."""
    grpc = _import_grpc()
    rpcs = {}
    for verb, (streaming, method, req, resp) in METHODS.items():
        make = (grpc.stream_stream_rpc_method_handler if streaming
                else grpc.unary_unary_rpc_method_handler)
        rpcs[verb] = make(
            _authed(getattr(svc, method), token,
                    grpc.StatusCode.UNAUTHENTICATED),
            request_deserializer=req.FromString,
            response_serializer=resp.SerializeToString,
        )
    return grpc.method_handlers_generic_handler(SERVICE_NAME, rpcs)


def serve_grpc(scheduler, address: str = "127.0.0.1:0",
               max_workers: int = 8, service=None, token=None):
    """Start the gRPC service; returns (server, bound_port). Pass an
    existing ``service`` to share it with a service-side cycle loop (which
    must hold ``service.lock`` around schedule_cycle). ``token`` gates
    every RPC behind `authorization: Bearer <token>` metadata (the wire
    seam's authentication filter); None/"" keeps the seam open. Raises
    ImportError naming ``grpcio`` where it is not installed."""
    grpc = _import_grpc()
    if service is not None and service.scheduler is not scheduler:
        raise ValueError(
            "serve_grpc: `service` wraps a different Scheduler than the one "
            "passed — RPCs would act on service.scheduler while the caller "
            "drives the other"
        )
    svc = service or TpuSchedulerService(scheduler)
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers),
                         options=_CHANNEL_OPTIONS)
    server.add_generic_rpc_handlers((_handlers(svc, token),))
    port = server.add_insecure_port(address)
    server.start()
    return server, port


class SnapshotDeltaBridge:
    """The control-plane shim: pumps a hub's watch events to the service
    as SnapshotDelta messages, preserving cross-kind event order (one
    delta per contiguous same-kind run — a node delete must not reorder
    around a pod bind): the control plane streaming deltas to the
    scheduler service. ``client`` is anything with ``sync_state`` (a
    :class:`GrpcSchedulerClient`, or another transport of the same
    messages).

    ``lock`` (pass the hub's own lock for a threaded caller) is held
    around list/poll so reads never race hub mutations; the wire send
    happens OUTSIDE it — a slow stream must not wedge the hub."""

    def __init__(self, hub, client, lock=None) -> None:
        import contextlib
        import os

        self.hub = hub
        self.client = client
        #: typed corev1 delta payloads — on by default, both ends in-repo;
        #: KTPU_PROTO_FEED=0 falls back to JSON strings
        self.proto_feed = os.environ.get("KTPU_PROTO_FEED", "1") == "1"
        self._lock = lock if lock is not None else contextlib.nullcontext()
        # LIST and cursor registration must be ONE atomic step: the hub
        # only appends history while a cursor is open (sim._commit), so
        # an event committed between list_state(rev) and watch(rev) —
        # with no other cursor alive — would vanish without ever raising
        # Compacted. The wire send happens after, outside the lock.
        # list_state's dicts hold LIVE object references the hub mutates
        # in place, so serialization must happen inside the lock too —
        # same hazard pump() documents; only the wire send stays outside
        with self._lock:
            rev, nodes, pods = hub.list_state()
            self.cursor = hub.watch(rev)
            d = pb.SnapshotDelta(revision=rev)
            for nd in nodes.values():
                d.nodes.add(op=pb.NodeDelta.ADD, name=nd.name,
                            **self._payload(nd, node_to_pb, node_to_json,
                                            "node_pb", "node_json"))
            for p in pods.values():
                d.pods.add(op=pb.PodDelta.ADD, key=p.key(),
                           **self._payload(p, pod_to_pb, pod_to_json,
                                           "pod_pb", "pod_json"))
        list(client.sync_state(iter([d])))

    def _payload(self, obj, to_pb, to_json, pb_field, json_field) -> dict:
        """The ONE proto-vs-JSON payload choice for every delta site:
        kwargs for the delta's add() — typed bytes when the proto feed
        is on and an object exists, else the JSON string ("" on REMOVE
        frames, which carry no object either way)."""
        if obj is None:
            return {json_field: ""}
        if self.proto_feed:
            return {pb_field: to_pb(obj).SerializeToString()}
        return {json_field: json.dumps(to_json(obj))}

    NODE_OPS = {"ADDED": pb.NodeDelta.ADD,
                "MODIFIED": pb.NodeDelta.UPDATE,
                "DELETED": pb.NodeDelta.REMOVE}
    POD_OPS = {"ADDED": pb.PodDelta.ADD,
               "MODIFIED": pb.PodDelta.UPDATE,
               "DELETED": pb.PodDelta.REMOVE}

    def pump(self) -> int:
        node_ops, pod_ops = self.NODE_OPS, self.POD_OPS
        # poll AND serialize under the lock: the hub commits live object
        # references into watch history and mutates them in place, so a
        # threaded caller racing this loop could tear the JSON (dict
        # changed size mid-iteration) or stamp a delta whose body
        # reflects a later revision than it claims. Only the wire send
        # stays outside — a slow stream must not wedge the hub.
        with self._lock:
            events = self.cursor.poll()
            if not events:
                return 0
            deltas = []
            cur_kind = None
            d = None
            for rev, obj_key, etype, obj in events:
                kind, _, ident = obj_key.partition("/")
                if kind not in ("nodes", "pods"):
                    continue  # leases/volumes/events aren't scheduler feed
                if d is None or kind != cur_kind:
                    d = pb.SnapshotDelta(revision=rev)
                    deltas.append(d)
                    cur_kind = kind
                d.revision = rev
                if kind == "nodes":
                    d.nodes.add(op=node_ops[etype], name=ident,
                                **self._payload(obj, node_to_pb,
                                                node_to_json,
                                                "node_pb", "node_json"))
                else:
                    d.pods.add(op=pod_ops[etype], key=ident,
                               **self._payload(obj, pod_to_pb, pod_to_json,
                                               "pod_pb", "pod_json"))
        if deltas:
            list(self.client.sync_state(iter(deltas)))
        return len(events)


class GrpcSchedulerClient:
    """The control plane's view: typed stubs over a channel (what a
    generated *_pb2_grpc.Stub provides). ``token`` attaches
    `authorization: Bearer <token>` metadata to every call (the client
    half of the seam's authentication).

    Robustness seams (kubernetes_tpu_torch/faults.py): ``retry`` — a
    RetryPolicy applying bounded exponential backoff + jitter around
    each unary call (transient UNAVAILABLE/DEADLINE_EXCEEDED survive a
    retry; the stream is NOT retried here — reconnect-and-resume is the
    bridge's job via acked revisions); ``fault_injector`` — the chaos
    harness hook, firing per-verb before the wire call ("grpc:Filter",
    "grpc:Bind", ...); ``obs`` — the observability facade, a
    ``grpc:{verb}`` span on the caller's in-flight cycle trace per call.
    Raises ImportError naming ``grpcio`` where it is not installed."""

    def __init__(self, target: str, token: "str | None" = None,
                 retry=None, fault_injector=None, obs=None):
        grpc = _import_grpc()
        self.target = target
        self.channel = grpc.insecure_channel(target,
                                             options=_CHANNEL_OPTIONS)
        self.retry = retry
        self.fault_injector = fault_injector
        self.obs = obs
        self._md = ([("authorization", f"Bearer {token}")]
                    if token else None)

        def with_md(callable_, verb: str = "", unary: bool = False):
            inj, md = self.fault_injector, self._md
            plain = (inj is None and obs is None
                     and not (unary and retry is not None))
            if md is None and plain:
                return callable_

            def call(*a, **kw):
                from contextlib import nullcontext

                if md is not None:
                    kw.setdefault("metadata", md)

                def once():
                    if inj is not None:
                        # raising kinds only on this typed seam: a
                        # corrupt frame fails the message decode, which
                        # grpc surfaces as an RpcError anyway
                        inj.transport_fault(f"grpc:{verb}")
                    return callable_(*a, **kw)

                span = (self.obs.span(f"grpc:{verb}")
                        if self.obs is not None else nullcontext())
                with span:
                    if unary and self.retry is not None:
                        return self.retry.call(once)
                    return once()

            return call

        base = f"/{SERVICE_NAME}/"
        for verb, (streaming, method, req, resp) in METHODS.items():
            make = (self.channel.stream_stream if streaming
                    else self.channel.unary_unary)
            setattr(self, method, with_md(make(
                base + verb,
                request_serializer=req.SerializeToString,
                response_deserializer=resp.FromString,
            ), verb, unary=not streaming))

    def close(self) -> None:
        self.channel.close()
