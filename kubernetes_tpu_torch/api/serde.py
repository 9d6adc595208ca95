"""Dataclass <-> JSON codec with Kubernetes-manifest field naming.

Replaces the reference's generated deepcopy/conversion/json machinery
(staging/src/k8s.io/apimachinery/pkg/runtime) with one reflective codec:
python dataclasses use snake_case; the wire format is the reference's
camelCase JSON, so real Kubernetes manifests round-trip.

Conventions:
  - field `api_version` <-> "apiVersion", `tls_config` <-> "tlsConfig", etc.
  - a field may override its wire name via metadata={"json": "name"}
  - Optional/None fields are omitted on encode (k8s `omitempty` semantics)
  - types with to_json()/from_json(cls, data) hooks (e.g. Quantity) use them
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import json
import typing
from typing import Any, Optional, Type, TypeVar, get_args, get_origin

T = TypeVar("T")


@functools.lru_cache(maxsize=None)
def _hints_of(tp) -> dict:
    """get_type_hints is pathologically slow (re-compiles annotation strings
    every call); dataclass hints are static, so cache per class."""
    return typing.get_type_hints(tp)


@functools.lru_cache(maxsize=None)
def _wire_fields(tp) -> tuple:
    """(field, wire_name, resolved_type) per dataclass field, cached."""
    hints = _hints_of(tp)
    return tuple((f, _wire_name(f), hints[f.name])
                 for f in dataclasses.fields(tp))

_ACRONYMS = {"ip": "IP", "cidr": "CIDR", "tls": "TLS", "uid": "UID", "url": "URL",
             "api": "API", "pvc": "PVC", "qos": "QOS", "id": "ID"}


def snake_to_camel(name: str) -> str:
    parts = name.split("_")
    out = [parts[0]]
    for p in parts[1:]:
        out.append(_ACRONYMS.get(p, p.capitalize()))
    # leading-acronym fields like `ip_family` -> ipFamily (first part stays lower)
    return "".join(out)


def _wire_name(f: dataclasses.Field) -> str:
    if "json" in f.metadata:
        return f.metadata["json"]
    return snake_to_camel(f.name)


def _is_optional(tp) -> bool:
    return get_origin(tp) is typing.Union and type(None) in get_args(tp)


def _strip_optional(tp):
    if _is_optional(tp):
        args = [a for a in get_args(tp) if a is not type(None)]
        return args[0] if len(args) == 1 else typing.Union[tuple(args)]
    return tp


def encode(obj: Any) -> Any:
    """Encode a dataclass (or container of them) to plain JSON-able data.

    Dataclasses go through per-class COMPILED encoders (same technique as
    the deepcopy copiers below): field dispatch is resolved once from the
    type hints, not re-inspected per value — the reflective path below is
    the fallback for values that deviate from their declared types."""
    if obj is None:
        return None
    cls = obj.__class__
    h = _ENCODERS.get(cls)
    if h is not None:
        return h(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _encoder_for(cls)(obj)
    return _encode_slow(obj)


def _encode_slow(obj: Any) -> Any:
    if obj is None:
        return None
    if hasattr(obj, "to_json") and not isinstance(obj, type):
        return obj.to_json()
    if isinstance(obj, enum.Enum):
        return obj.value
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if v is None:
                continue
            if v == [] or v == {}:
                # omitempty — but only when empty IS the field's default
                # (default_factory). For Optional fields (default None) an
                # empty dict is meaningful: `emptyDir: {}` marks the volume
                # source type and must survive round-trips.
                if (f.default_factory is not dataclasses.MISSING
                        and not f.metadata.get("keep_empty")):
                    continue
            out[_wire_name(f)] = encode(v)
        return out
    if isinstance(obj, dict):
        return {k: encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [encode(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)):
        return obj
    raise TypeError(f"cannot encode {type(obj)!r}")


def decode(cls: Type[T], data: Any) -> T:
    """Decode JSON-able data into an instance of dataclass `cls` (per-class
    compiled decoders; the reflective _decode_value is the fallback)."""
    if data is None:
        return None
    h = _DECODERS.get(cls)
    if h is not None:
        return h(data)
    if isinstance(cls, type) and dataclasses.is_dataclass(cls) \
            and not hasattr(cls, "from_json"):
        return _decoder_for(cls)(data)
    return _decode_value(cls, data)


def _decode_value(tp, data):
    if data is None:
        return None
    tp = _strip_optional(tp)
    origin = get_origin(tp)
    if origin in (list, tuple):
        (elem,) = get_args(tp) or (Any,)
        return [_decode_value(elem, v) for v in data]
    if origin is dict:
        args = get_args(tp)
        vt = args[1] if len(args) == 2 else Any
        return {k: _decode_value(vt, v) for k, v in data.items()}
    if tp is Any:
        return data
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        return tp(data)
    if hasattr(tp, "from_json"):
        return tp.from_json(data)
    if dataclasses.is_dataclass(tp):
        kwargs = {}
        for f, wire, ftp in _wire_fields(tp):
            if wire in data:
                kwargs[f.name] = _decode_value(ftp, data[wire])
        return tp(**kwargs)
    if tp is float and isinstance(data, int):
        return float(data)
    return data


# --------------------------------------------------------- compiled codecs

_ENCODERS: dict = {}
_DECODERS: dict = {}

_SCALARS = (str, int, float, bool)


def _encoder_for(cls):
    h = _ENCODERS.get(cls)
    if h is None:
        h = _build_encoder(cls)
    return h


def _decoder_for(cls):
    h = _DECODERS.get(cls)
    if h is None:
        h = _build_decoder(cls)
    return h


def _codec_kind(tp):
    """Classify a RESOLVED (non-Optional) hint for codegen."""
    if tp in _SCALARS:
        return "scalar", tp
    if tp is Any:
        return "any", None
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        return "enum", tp
    if isinstance(tp, type) and hasattr(tp, "from_json"):
        return "value", tp  # Quantity-style value object
    if isinstance(tp, type) and dataclasses.is_dataclass(tp):
        return "dataclass", tp
    origin = get_origin(tp)
    if origin in (list, tuple):
        args = get_args(tp)
        return "list", (args[0] if args else Any)
    if origin is dict:
        args = get_args(tp)
        return "dict", (args[1] if len(args) == 2 else Any)
    if tp is dict:
        return "rawdict", None
    if tp is list:
        return "rawlist", None
    return "other", tp


def _build_encoder(cls):
    if not (isinstance(cls, type) and dataclasses.is_dataclass(cls)) or \
            hasattr(cls, "to_json"):
        _ENCODERS[cls] = _encode_slow
        return _encode_slow
    _ENCODERS[cls] = _encode_slow  # recursion guard during build
    hints = _hints_of(cls)
    src = ["def _enc(v):", "    d = v.__dict__", "    out = {}"]
    ns = {"_slow": _encode_slow}
    for i, f in enumerate(dataclasses.fields(cls)):
        n, wire = f.name, _wire_name(f)
        kind, sub = _codec_kind(_strip_optional(hints[n]))
        drop_empty = (f.default_factory is not dataclasses.MISSING
                      and not f.metadata.get("keep_empty"))
        src.append(f"    x = d[{n!r}]")
        src.append("    if x is not None:")
        if kind in ("list", "dict", "rawdict", "rawlist") and drop_empty:
            guard = "        if x:"
        elif drop_empty:
            # non-container field with a default_factory (rare): keep the
            # reflective empty semantics
            guard = "        if x != [] and x != {}:"
        else:
            guard = "        if True:"
        src.append(guard)
        pre = "            "
        if kind == "scalar":
            src.append(f"{pre}out[{wire!r}] = x if x.__class__ in _SC "
                       f"else _slow(x)")
            ns["_SC"] = frozenset(_SCALARS)
        elif kind == "enum":
            src.append(f"{pre}out[{wire!r}] = x.value "
                       f"if isinstance(x, _E{i}) else _slow(x)")
            ns[f"_E{i}"] = sub
        elif kind == "value":
            src.append(f"{pre}out[{wire!r}] = x.to_json() "
                       f"if isinstance(x, _V{i}) else _slow(x)")
            ns[f"_V{i}"] = sub
        elif kind == "dataclass":
            ns[f"_d{i}"] = sub
            ns[f"_s{i}"] = _encoder_for(sub) if sub is not cls else None
            if sub is cls:
                src.append(f"{pre}out[{wire!r}] = _enc(x) "
                           f"if x.__class__ is _d{i} else _slow(x)")
            else:
                src.append(f"{pre}out[{wire!r}] = _s{i}(x) "
                           f"if x.__class__ is _d{i} else _slow(x)")
        elif kind == "list":
            ekind, esub = _codec_kind(_strip_optional(sub))
            if ekind == "scalar":
                src.append(f"{pre}out[{wire!r}] = list(x) "
                           f"if isinstance(x, (list, tuple)) else _slow(x)")
            elif ekind == "dataclass" and esub is not cls:
                ns[f"_el{i}"] = esub
                ns[f"_es{i}"] = _encoder_for(esub)
                src.append(
                    f"{pre}out[{wire!r}] = ["
                    f"_es{i}(e) if e.__class__ is _el{i} else _slow(e) "
                    f"for e in x] if isinstance(x, (list, tuple)) "
                    f"else _slow(x)")
            elif ekind == "value":
                ns[f"_el{i}"] = esub
                src.append(
                    f"{pre}out[{wire!r}] = ["
                    f"e.to_json() if isinstance(e, _el{i}) else _slow(e) "
                    f"for e in x] if isinstance(x, (list, tuple)) "
                    f"else _slow(x)")
            else:
                src.append(f"{pre}out[{wire!r}] = _slow(x)")
        elif kind == "dict":
            vkind, vsub = _codec_kind(_strip_optional(sub))
            if vkind == "scalar":
                src.append(f"{pre}out[{wire!r}] = dict(x) "
                           f"if isinstance(x, dict) else _slow(x)")
            elif vkind == "value":
                ns[f"_dv{i}"] = vsub
                src.append(
                    f"{pre}out[{wire!r}] = {{"
                    f"k: (e.to_json() if isinstance(e, _dv{i}) "
                    f"else _slow(e)) for k, e in x.items()}} "
                    f"if isinstance(x, dict) else _slow(x)")
            else:
                src.append(f"{pre}out[{wire!r}] = _slow(x)")
        elif kind in ("rawdict", "rawlist", "any", "other"):
            src.append(f"{pre}out[{wire!r}] = _slow(x)")
    src.append("    return out")
    exec(compile("\n".join(src), f"<encoder {cls.__name__}>", "exec"), ns)
    h = ns["_enc"]
    _ENCODERS[cls] = h
    return h


def _build_decoder(cls):
    if not (isinstance(cls, type) and dataclasses.is_dataclass(cls)) or \
            hasattr(cls, "from_json"):
        h = lambda data: _decode_value(cls, data)  # noqa: E731
        _DECODERS[cls] = h
        return h
    _DECODERS[cls] = lambda data: _decode_value(cls, data)  # recursion guard
    src = ["def _dec(data):", "    kw = {}"]
    ns = {"_cls": cls, "_dv": _decode_value, "_Any": Any}
    for i, (f, wire, ftp) in enumerate(_wire_fields(cls)):
        n = f.name
        kind, sub = _codec_kind(_strip_optional(ftp))
        src.append(f"    if {wire!r} in data:")
        src.append(f"        x = data[{wire!r}]")
        pre = "        "
        if kind == "scalar" and sub is not float:
            src.append(f"{pre}kw[{n!r}] = x")
        elif kind == "scalar":  # float accepts wire ints
            src.append(f"{pre}kw[{n!r}] = float(x) "
                       f"if isinstance(x, int) else x")
        elif kind in ("any", "rawdict", "rawlist", "other"):
            if kind == "other":
                ns[f"_t{i}"] = sub
                src.append(f"{pre}kw[{n!r}] = _dv(_t{i}, x)")
            else:
                src.append(f"{pre}kw[{n!r}] = x")
        elif kind == "enum":
            ns[f"_e{i}"] = sub
            src.append(f"{pre}kw[{n!r}] = _e{i}(x) "
                       f"if x is not None else None")
        elif kind == "value":
            ns[f"_v{i}"] = sub
            src.append(f"{pre}kw[{n!r}] = _v{i}.from_json(x) "
                       f"if x is not None else None")
        elif kind == "dataclass":
            ns[f"_t{i}"] = sub
            if sub is cls:
                src.append(f"{pre}kw[{n!r}] = _dec(x) "
                           f"if isinstance(x, dict) else _dv(_t{i}, x)")
            else:
                ns[f"_s{i}"] = _decoder_for(sub)
                src.append(f"{pre}kw[{n!r}] = _s{i}(x) "
                           f"if isinstance(x, dict) else _dv(_t{i}, x)")
        elif kind == "list":
            ekind, esub = _codec_kind(_strip_optional(sub))
            if ekind == "scalar":
                src.append(f"{pre}kw[{n!r}] = list(x) "
                           f"if isinstance(x, list) else _dv(_lt{i}, x)")
                ns[f"_lt{i}"] = ftp
            elif ekind == "dataclass" and esub is not cls:
                ns[f"_el{i}"] = _decoder_for(esub)
                ns[f"_lt{i}"] = ftp
                src.append(
                    f"{pre}kw[{n!r}] = ["
                    f"_el{i}(e) if isinstance(e, dict) else e "
                    f"for e in x] if isinstance(x, list) "
                    f"else _dv(_lt{i}, x)")
            elif ekind == "value":
                ns[f"_el{i}"] = esub
                ns[f"_lt{i}"] = ftp
                src.append(
                    f"{pre}kw[{n!r}] = ["
                    f"_el{i}.from_json(e) for e in x] "
                    f"if isinstance(x, list) else _dv(_lt{i}, x)")
            else:
                ns[f"_lt{i}"] = ftp
                src.append(f"{pre}kw[{n!r}] = _dv(_lt{i}, x)")
        elif kind == "dict":
            vkind, vsub = _codec_kind(_strip_optional(sub))
            if vkind == "scalar":
                src.append(f"{pre}kw[{n!r}] = dict(x) "
                           f"if isinstance(x, dict) else _dv(_dt{i}, x)")
                ns[f"_dt{i}"] = ftp
            elif vkind == "value":
                ns[f"_dv{i}"] = vsub
                ns[f"_dt{i}"] = ftp
                src.append(
                    f"{pre}kw[{n!r}] = {{"
                    f"k: _dv{i}.from_json(e) for k, e in x.items()}} "
                    f"if isinstance(x, dict) else _dv(_dt{i}, x)")
            else:
                ns[f"_dt{i}"] = ftp
                src.append(f"{pre}kw[{n!r}] = _dv(_dt{i}, x)")
    src.append("    return _cls(**kw)")
    exec(compile("\n".join(src), f"<decoder {cls.__name__}>", "exec"), ns)
    h = ns["_dec"]
    _DECODERS[cls] = h
    return h


def to_json_str(obj: Any, **kw) -> str:
    return json.dumps(encode(obj), **kw)


def encode_cached(obj: Any) -> Any:
    """encode() memoized per (object, resourceVersion) for store-frozen
    objects.

    The store keeps ONE canonical frozen object per key and stamps a fresh
    resourceVersion on every write, so an rv-matched cache entry can never
    be stale — invalidation is the rv re-stamp itself. This collapses the
    hub's per-watcher/per-list/per-journal re-encodes of the same revision
    into one: the reference pays the same cost once via the watch cache's
    cached serializations (storage/cacher). Objects without an rv (not yet
    stored) fall through to plain encode()."""
    meta = getattr(obj, "metadata", None)
    rv = getattr(meta, "resource_version", "") if meta is not None else ""
    if not rv:
        return encode(obj)
    c = obj.__dict__.get("_enc_cache")
    if c is not None and c[0] == rv:
        return c[1]
    d = encode(obj)
    obj.__dict__["_enc_cache"] = (rv, d, None)
    return d


def to_json_cached(obj: Any) -> str:
    """JSON string form of encode_cached(), itself cached — the watch
    fan-out and list paths serve the identical bytes to every consumer."""
    meta = getattr(obj, "metadata", None)
    rv = getattr(meta, "resource_version", "") if meta is not None else ""
    if not rv:
        return json.dumps(encode(obj))
    c = obj.__dict__.get("_enc_cache")
    if c is not None and c[0] == rv and c[2] is not None:
        return c[2]
    d = c[1] if c is not None and c[0] == rv else encode(obj)
    s = json.dumps(d)
    obj.__dict__["_enc_cache"] = (rv, d, s)
    return s


def from_json_str(cls: Type[T], s: str) -> T:
    return decode(cls, json.loads(s))


def deepcopy_obj(obj: T) -> T:
    """Semantic deep copy (mirrors generated DeepCopy) — structural, without
    the wire round trip; hot path for every store write.

    Per-class copiers are compiled once from the dataclass's resolved field
    hints (the analog of the reference's generated zz_generated.deepcopy.go):
    fields whose declared type is immutable (str/int/float/bool/enum/value
    objects like Quantity) are reference-shared; everything else recurses.
    """
    return _copy_value(obj)


def shallow_bind_clone(pod: T) -> T:
    """Clone exactly the layers a bind/assume mutates — the object shell,
    metadata, spec, status, and the status.conditions entries — sharing every
    other sub-object (containers, labels, ...) with the frozen source.

    The per-pod deep copy is the bind path's hottest host cost at batch
    sizes; the reference pays one API round trip per bind instead
    (scheduler.go:549). Sharing is safe under the store's read-only
    discipline: both the old and new canonical objects are frozen.

    Uses raw __dict__ copies instead of copy.copy: these are plain
    dataclasses (no __slots__), and skipping the __reduce_ex__ protocol is
    ~4x faster on the 50k-pod bench.
    """
    new = _dict_copy(pod)
    new.metadata = _dict_copy(pod.metadata)
    new.spec = _dict_copy(pod.spec)
    new.status = _dict_copy(pod.status)
    new.status.conditions = [_dict_copy(c) for c in pod.status.conditions]
    return new


def shallow_meta_clone(obj: T) -> T:
    """Clone only the object shell + metadata — the layers a delete path
    or a resourceVersion restamp mutates — sharing spec/status/everything
    else with the frozen source (the delete/restamp analog of
    shallow_bind_clone, same read-only-discipline safety argument)."""
    new = _dict_copy(obj)
    new.metadata = _dict_copy(obj.metadata)
    return new


def _dict_copy(obj):
    new = object.__new__(obj.__class__)
    new.__dict__ = obj.__dict__.copy()
    return new


def _copy_dict(v):
    return {k: _copy_value(x) for k, x in v.items()}


def _copy_list(v):
    return [_copy_value(x) for x in v]


def _identity(v):
    return v


_COPIERS: dict = {
    str: _identity, int: _identity, float: _identity, bool: _identity,
    type(None): _identity, dict: _copy_dict, list: _copy_list,
    tuple: lambda v: tuple(_copy_value(x) for x in v),
}


def _copy_value(v):
    h = _COPIERS.get(v.__class__)
    if h is None:
        h = _build_copier(v.__class__)
    return h(v)


def _immutable_hint(tp) -> bool:
    """True when every runtime value of this declared type is safe to share."""
    tp = _strip_optional(tp)
    if tp in (str, int, float, bool):
        return True
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        return True
    # value objects (Quantity): immutable by contract, marked by to_json
    if isinstance(tp, type) and hasattr(tp, "to_json"):
        return True
    return False


def _dataclass_hint(tp):
    """The field's dataclass when tp is (Optional) SomeDataclass, else None."""
    tp = _strip_optional(tp)
    if isinstance(tp, type) and dataclasses.is_dataclass(tp) \
            and not hasattr(tp, "to_json"):
        return tp
    return None


def _copier_for(cls):
    h = _COPIERS.get(cls)
    if h is None:
        h = _build_copier(cls)
    return h


def _build_copier(cls):
    if not (isinstance(cls, type) and dataclasses.is_dataclass(cls)):
        _COPIERS[cls] = _identity  # unknown leaf: share by reference
        return _identity
    if hasattr(cls, "to_json"):  # value object (Quantity)
        _COPIERS[cls] = _identity
        return _identity
    # register a fallback first so self-referential types don't recurse
    # during build; replaced with the compiled copier below
    _COPIERS[cls] = lambda v: _generic_dataclass_copy(v)
    hints = _hints_of(cls)
    src = ["def _copy(v):",
           "    d = v.__dict__",
           "    out = _object_new(_cls)",
           "    od = out.__dict__"]
    ns = {"_object_new": object.__new__, "_cls": cls, "_cp": _copy_value}
    for f in dataclasses.fields(cls):
        n = f.name
        tp = hints[n]
        if _immutable_hint(tp):
            src.append(f"    od[{n!r}] = d[{n!r}]")
            continue
        elem = _dataclass_hint(tp)
        if elem is not None and elem is not cls:
            sub = f"_sub_{n}"
            ns[sub] = _copier_for(elem)
            src.append(f"    x = d[{n!r}]")
            src.append(f"    od[{n!r}] = {sub}(x) if x is not None else None")
            continue
        stripped = _strip_optional(tp)
        origin = get_origin(stripped)
        if origin is list:
            args = get_args(stripped)
            el = args[0] if args else Any
            if _immutable_hint(el):
                src.append(f"    x = d[{n!r}]")
                src.append(f"    od[{n!r}] = x[:] if x is not None else None")
                continue
            el_dc = _dataclass_hint(el)
            if el_dc is not None and el_dc is not cls:
                sub = f"_sub_{n}"
                ns[sub] = _copier_for(el_dc)
                src.append(f"    x = d[{n!r}]")
                src.append(f"    od[{n!r}] = [{sub}(e) for e in x] "
                           f"if x is not None else None")
                continue
        elif origin is dict:
            args = get_args(stripped)
            if len(args) == 2 and _immutable_hint(args[1]):
                src.append(f"    x = d[{n!r}]")
                src.append(f"    od[{n!r}] = dict(x) if x is not None else None")
                continue
        src.append(f"    x = d[{n!r}]")
        src.append(f"    od[{n!r}] = _cp(x) if x is not None else None")
    src.append("    return out")
    exec(compile("\n".join(src), f"<copier {cls.__name__}>", "exec"), ns)
    h = ns["_copy"]
    _COPIERS[cls] = h
    return h


def _generic_dataclass_copy(v):
    out = object.__new__(type(v))
    for f in dataclasses.fields(v):
        setattr(out, f.name, _copy_value(getattr(v, f.name)))
    return out
