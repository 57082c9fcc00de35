"""Versioned API machinery — the ``runtime.Scheme`` analog (the port's
copy of ``kubernetes_tpu/api/scheme.py``).

The reference's entire API-stability story runs through one registry
(staging/src/k8s.io/apimachinery/pkg/runtime/scheme.go:46): types are
registered under a (group, version, kind), versioned objects get
DEFAULTING functions, and CONVERSION functions map between each
versioned type and a single internal ("hub") type.  Decoding is then
always the same pipeline (serializer/codec_factory.go + conversion in
scheme.go:340 Convert):

    bytes -> recognize apiVersion/kind -> build the VERSIONED object
    (strict: unknown fields are errors, serializer/json strict mode)
    -> apply that version's defaults -> convert to INTERNAL

and encoding is the reverse (internal -> convert to the requested
version).  This module is that pipeline over plain dataclasses: versioned
types are dataclasses whose FIELD NAMES are the wire spelling (camelCase,
as in the reference's external types), the internal types are whatever
the framework uses natively (snake_case dataclasses).

Used by apis/config (the scheduler ComponentConfig scheme,
pkg/scheduler/apis/config/scheme/scheme.go:31): see
:mod:`kubernetes_tpu_torch.api.config_v1alpha1`.
"""

from __future__ import annotations

import dataclasses
import functools
import typing
from typing import Callable, Dict, List, Tuple, Type


class SchemeError(ValueError):
    """Decode/conversion failure; ``errors`` lists field-path messages."""

    def __init__(self, errors: List[str]):
        super().__init__("; ".join(errors))
        self.errors = list(errors)


class Scheme:
    """Type registry + defaulting + conversion (scheme.go:46).

    - :meth:`register` a versioned dataclass under its (apiVersion, kind);
    - :meth:`add_defaulting` that version's SetDefaults_* function
      (mutates or returns the versioned object — defaulting runs BEFORE
      conversion, scheme.go:764 Default);
    - :meth:`add_conversion` a (src_type, dst_type) function pair —
      registered both ways for a round-trippable version;
    - :meth:`decode` a JSON/YAML mapping all the way to the internal type;
    - :meth:`convert` between any two registered types;
    - :meth:`encode` an internal object back to a versioned mapping.
    """

    def __init__(self) -> None:
        self._kinds: Dict[Tuple[str, str], Type] = {}
        self._defaulters: Dict[Type, Callable] = {}
        self._conversions: Dict[Tuple[Type, Type], Callable] = {}

    # -- registration -------------------------------------------------------

    def register(self, api_version: str, kind: str, typ: Type) -> None:
        if not dataclasses.is_dataclass(typ):
            raise TypeError(f"{typ!r} must be a dataclass")
        self._kinds[(api_version, kind)] = typ

    def add_defaulting(self, typ: Type, fn: Callable) -> None:
        self._defaulters[typ] = fn

    def add_conversion(self, src: Type, dst: Type, fn: Callable) -> None:
        self._conversions[(src, dst)] = fn

    def recognizes(self, api_version: str, kind: str) -> bool:
        return (api_version, kind) in self._kinds

    # -- pipeline -----------------------------------------------------------

    def default(self, obj):
        """Apply the registered defaulting function, if any (Default,
        scheme.go:764). Returns the defaulted object."""
        fn = self._defaulters.get(type(obj))
        if fn is None:
            return obj
        return fn(obj) or obj

    def convert(self, obj, to_type: Type):
        """Convert between registered types (Convert, scheme.go:340).
        Identity conversion is free; unknown pairs are errors, never a
        silent field-copy (the reference's reflection fallback is a
        DELIBERATE non-goal — silent structural conversion is how fields
        get dropped)."""
        if type(obj) is to_type:
            return obj
        fn = self._conversions.get((type(obj), to_type))
        if fn is None:
            raise SchemeError([
                f"no conversion registered: {type(obj).__name__} -> "
                f"{to_type.__name__}"
            ])
        return fn(obj)

    def build(self, api_version: str, kind: str, doc: dict, path: str = ""):
        """Mapping -> versioned object, strict (unknown fields are
        field-path errors, the strict-serializer posture the reference
        uses for ComponentConfig)."""
        typ = self._kinds.get((api_version, kind))
        if typ is None:
            raise SchemeError([
                f'no kind "{kind}" is registered for version "{api_version}"'
            ])
        return _build_dataclass(typ, doc, path or kind)

    def decode(self, doc: dict, internal_type: Type):
        """The full decode pipeline: recognize -> build versioned (strict)
        -> default -> convert to ``internal_type``."""
        api_version, kind, body = _split_doc(doc)
        versioned = self.build(api_version, kind, body)
        versioned = self.default(versioned)
        return self.convert(versioned, internal_type)

    def encode(self, obj, api_version: str, kind: str) -> dict:
        """internal -> versioned mapping with apiVersion/kind stamped
        (the codec's encode direction)."""
        typ = self._kinds.get((api_version, kind))
        if typ is None:
            raise SchemeError([
                f'no kind "{kind}" is registered for version "{api_version}"'
            ])
        versioned = self.convert(obj, typ)
        out = {"apiVersion": api_version, "kind": kind}
        out.update(_dataclass_to_doc(versioned))
        return out


@functools.lru_cache(maxsize=None)
def _type_hints(typ: Type) -> dict:
    """Resolved annotations per type, cached: get_type_hints re-eval()s
    every string annotation on each call, and bulk decode paths visit
    the same handful of types thousands of times. It handles
    Optional[...], cross-module references, and forward refs — the bare
    getattr-on-module lookup it replaced silently resolved those to
    None and skipped strict recursive construction, stuffing the raw
    mapping into the field (ADVICE r4)."""
    try:
        return typing.get_type_hints(typ)
    except Exception:
        return {}


def _build_dataclass(typ: Type, doc: dict, path: str):
    """Strict recursive dataclass construction: every key must name a
    field; mapping-valued fields whose type is itself a dataclass recurse
    with an extended field path (the shape of field-path errors in
    apimachinery validation)."""
    if not isinstance(doc, dict):
        raise SchemeError([f"{path}: expected a mapping"])
    fields = {f.name: f for f in dataclasses.fields(typ)}
    hints = _type_hints(typ)
    errs: List[str] = []
    kw: dict = {}
    for key, val in doc.items():
        f = fields.get(key)
        if f is None:
            errs.append(f"{path}.{key}: unknown field")
            continue
        ftyp = f.type if isinstance(f.type, type) else hints.get(key)
        origin = typing.get_origin(ftyp)
        # typing.Optional[X] has origin typing.Union; PEP 604 `X | None`
        # has origin types.UnionType — both must unwrap or a nested
        # dataclass silently skips strict construction
        import types as _types

        if origin is typing.Union or origin is _types.UnionType:
            non_none = [a for a in typing.get_args(ftyp)
                        if a is not type(None)]
            ftyp = non_none[0] if len(non_none) == 1 else None
        if not isinstance(ftyp, type):
            ftyp = None
        if ftyp is not None and dataclasses.is_dataclass(ftyp) and not (
                dataclasses.is_dataclass(type(val))):
            try:
                kw[key] = _build_dataclass(ftyp, val, f"{path}.{key}")
            except SchemeError as e:
                errs.extend(e.errors)
        else:
            kw[key] = val
    if errs:
        raise SchemeError(errs)
    try:
        return typ(**kw)
    except TypeError as e:
        raise SchemeError([f"{path}: {e}"])


def _dataclass_to_doc(obj) -> dict:
    """Versioned dataclass -> plain mapping, recursing into nested
    dataclasses, dropping None (the wire form omits unset pointers)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None:
            continue
        if dataclasses.is_dataclass(type(v)):
            v = _dataclass_to_doc(v)
        out[f.name] = v
    return out


def _split_doc(doc: dict):
    """(apiVersion, kind, body) of a wire document — the one recognize+
    strip both codecs (typed Scheme.decode and decode_unstructured)
    validate through, so the dynamic and typed paths can never drift on
    what counts as a decodable document."""
    if not isinstance(doc, dict):
        raise SchemeError(["document: expected a mapping"])
    api_version = doc.get("apiVersion", "")
    kind = doc.get("kind", "")
    if not api_version or not kind:
        raise SchemeError(["apiVersion and kind are required"])
    body = {k: v for k, v in doc.items()
            if k not in ("apiVersion", "kind")}
    return api_version, kind, body


class Unstructured:
    """apimachinery's unstructured.Unstructured analog
    (apimachinery/pkg/apis/meta/v1/unstructured/unstructured.go:41): a
    dict-backed object for kinds no typed codec is registered for —
    what dynamic clients and the GC's partial-metadata reads decode
    into. The document IS the object; accessors read the well-known
    metadata paths without requiring them."""

    def __init__(self, doc: dict) -> None:
        if not isinstance(doc, dict):
            raise SchemeError(["unstructured: expected a mapping"])
        self.doc = dict(doc)

    @property
    def api_version(self) -> str:
        return self.doc.get("apiVersion", "")

    @property
    def kind(self) -> str:
        return self.doc.get("kind", "")

    @property
    def name(self) -> str:
        return (self.doc.get("metadata") or {}).get("name", "")

    @property
    def namespace(self) -> str:
        return (self.doc.get("metadata") or {}).get("namespace", "")

    @property
    def labels(self) -> dict:
        return dict((self.doc.get("metadata") or {}).get("labels") or {})

    def get(self, *path, default=None):
        """NestedFieldNoCopy (unstructured helpers): walk a field path,
        None-safe — ``u.get("spec", "replicas")``."""
        cur = self.doc
        for p in path:
            if not isinstance(cur, dict) or p not in cur:
                return default
            cur = cur[p]
        return cur

    def to_doc(self) -> dict:
        return dict(self.doc)

    def __eq__(self, other) -> bool:
        return isinstance(other, Unstructured) and self.doc == other.doc

    def __repr__(self) -> str:
        return f"Unstructured({self.api_version}/{self.kind} {self.name})"


def decode_unstructured(scheme: Scheme, doc: dict):
    """UnstructuredJSONScheme's decode split (the dynamic client's
    codec): a registered (apiVersion, kind) routes through the TYPED
    strict pipeline (built + defaulted at its versioned type — the
    caller converts onward when it wants an internal form); anything
    else becomes :class:`Unstructured`. apiVersion/kind are still
    required — the reference's unstructured decoder rejects kind-less
    documents too."""
    api_version, kind, body = _split_doc(doc)
    if not scheme.recognizes(api_version, kind):
        return Unstructured(doc)
    return scheme.default(scheme.build(api_version, kind, body))
