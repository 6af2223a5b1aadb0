"""Reversible flattening of nested app-state containers into logical paths.

A copy of ``torchsnapshot_tpu/flatten.py``, unchanged in logic: nested
``dict`` / ``OrderedDict`` / ``list`` / ``tuple`` / namedtuple containers
flatten into ``{logical_path: leaf}`` plus a manifest of container entries,
so ``inflate`` rebuilds the structure exactly.  Tensors are leaves.

Path grammar: components joined with ``/``; literal ``%`` and ``/`` inside
keys are escaped as ``%25`` / ``%2F``.  A dict whose keys collide after
str() conversion, or whose keys are not str/int, is kept as an opaque leaf
and pickled.  Int keys (optimizer state dicts) are recorded verbatim, so
they come back as ints.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Tuple

from .manifest import (
    DictEntry,
    ListEntry,
    Manifest,
    NamedTupleEntry,
    OrderedDictEntry,
    TupleEntry,
)

STATE_DICT_KEY_SEPARATOR = "/"


def _encode(component: str) -> str:
    if component == "":
        # An empty key would produce a path equal to its parent container's
        # own path, silently overwriting the container entry (data loss the
        # reference grammar shares; found by the hypothesis round trip).
        # "%0" cannot collide: escaping only ever emits %25/%2F, and a
        # literal "%0" key escapes to "%250".
        return "%0"
    return component.replace("%", "%25").replace("/", "%2F")


def _decode(component: str) -> str:
    if component == "%0":
        return ""
    return component.replace("%2F", "/").replace("%25", "%")


def _join(prefix: str, component: str) -> str:
    encoded = _encode(component)
    return f"{prefix}{STATE_DICT_KEY_SEPARATOR}{encoded}" if prefix else encoded


def _dict_is_flattenable(obj: Dict[Any, Any]) -> bool:
    keys = list(obj.keys())
    if not all(isinstance(k, (str, int)) for k in keys):
        return False
    str_keys = [str(k) for k in keys]
    return len(set(str_keys)) == len(str_keys)


def flatten(obj: Any, prefix: str = "") -> Tuple[Manifest, Dict[str, Any]]:
    """Flatten a nested container into (container manifest, {path: leaf}).

    Mirrors reference semantics (flatten.py:20-77): containers are recorded as
    entries keyed by their own logical path; leaves are returned separately.
    """
    manifest: Manifest = {}
    flattened: Dict[str, Any] = {}
    _flatten_inner(obj, manifest, flattened, prefix)
    return manifest, flattened


def _flatten_inner(
    obj: Any, manifest: Manifest, flattened: Dict[str, Any], prefix: str
) -> None:
    if isinstance(obj, OrderedDict) and _dict_is_flattenable(obj):
        manifest[prefix] = OrderedDictEntry(keys=list(obj.keys()))
        for key, value in obj.items():
            _flatten_inner(value, manifest, flattened, _join(prefix, str(key)))
    elif isinstance(obj, dict) and _dict_is_flattenable(obj):
        manifest[prefix] = DictEntry(keys=list(obj.keys()))
        for key, value in obj.items():
            _flatten_inner(value, manifest, flattened, _join(prefix, str(key)))
    elif isinstance(obj, list):
        manifest[prefix] = ListEntry()
        for idx, value in enumerate(obj):
            _flatten_inner(value, manifest, flattened, _join(prefix, str(idx)))
    elif isinstance(obj, tuple) and type(obj) is tuple:
        manifest[prefix] = TupleEntry()
        for idx, value in enumerate(obj):
            _flatten_inner(value, manifest, flattened, _join(prefix, str(idx)))
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        # NamedTuples are first-class containers: optax optimizer states
        # (ScaleByAdamState & co.) must not collapse into opaque pickles —
        # their array fields need the sharded-array machinery.
        cls = type(obj)
        manifest[prefix] = NamedTupleEntry(
            keys=list(obj._fields), cls=f"{cls.__module__}:{cls.__qualname__}"
        )
        for field, value in zip(obj._fields, obj):
            _flatten_inner(value, manifest, flattened, _join(prefix, field))
    else:
        flattened[prefix] = obj


def inflate(
    manifest: Manifest, flattened: Dict[str, Any], prefix: str = ""
) -> Any:
    """Rebuild the nested structure from container entries + leaves.

    Mirrors reference semantics (flatten.py:79-143), including re-interpreting
    integer-looking dict keys as ints when the original dict declared int keys
    (flatten.py:186-201 in the reference handles this via recorded key lists;
    we record the original keys verbatim in Dict/OrderedDict entries, so the
    reconstruction is exact).
    """
    # Group every path by its container prefix so we can build bottom-up.
    children: Dict[str, List[Tuple[str, Any, bool]]] = {}
    all_paths: Dict[str, Tuple[Any, bool]] = {}
    for path, entry in manifest.items():
        all_paths[path] = (entry, True)
    for path, value in flattened.items():
        all_paths[path] = (value, False)

    def _parent_and_component(path: str) -> Tuple[str, str]:
        idx = path.rfind(STATE_DICT_KEY_SEPARATOR)
        if idx == -1:
            return "", path
        return path[:idx], path[idx + 1 :]

    for path, (value, is_container) in all_paths.items():
        if path == prefix:
            continue
        parent, component = _parent_and_component(path)
        children.setdefault(parent, []).append((component, value, is_container))

    built: Dict[str, Any] = {}

    def _build(path: str) -> Any:
        if path in built:
            return built[path]
        value, is_container = all_paths[path]
        if not is_container:
            built[path] = value
            return value
        entry = value
        kids = children.get(path, [])
        kid_map: Dict[str, Any] = {}
        for component, _, _ in kids:
            kid_path = (
                f"{path}{STATE_DICT_KEY_SEPARATOR}{component}" if path else component
            )
            kid_map[component] = _build(kid_path)

        if isinstance(entry, (ListEntry, TupleEntry)):
            items = sorted(((int(_decode(c)), v) for c, v in kid_map.items()))
            seq = [v for _, v in items]
            result: Any = tuple(seq) if isinstance(entry, TupleEntry) else seq
        elif isinstance(entry, NamedTupleEntry):
            values = [kid_map[_encode(field)] for field in entry.keys]
            result = _reconstruct_namedtuple(entry, values)
        elif isinstance(entry, (DictEntry, OrderedDictEntry)):
            cls = OrderedDict if isinstance(entry, OrderedDictEntry) else dict
            result = cls()
            for key in entry.keys:
                component = _encode(str(key))
                if component not in kid_map and str(key) == "":
                    # Snapshots written before the "%0" empty-key marker
                    # stored nested empty keys as bare "" components (which
                    # round-tripped except at root level) — keep restoring
                    # them.
                    component = ""
                if component in kid_map:
                    result[key] = kid_map[component]
        else:  # pragma: no cover - future container types
            raise AssertionError(f"Unknown container entry: {entry}")
        built[path] = result
        return result

    if prefix not in all_paths:
        raise RuntimeError(
            f"inflate: prefix {prefix!r} not present in manifest or leaves"
        )
    return _build(prefix)


def _reconstruct_namedtuple(entry: Any, values: list) -> Any:
    import importlib
    from collections import namedtuple as _namedtuple

    try:
        module_name, _, qualname = entry.cls.partition(":")
        obj: Any = importlib.import_module(module_name)
        for part in qualname.split("."):
            obj = getattr(obj, part)
        return obj(*values)
    except Exception:
        # Class not importable here: degrade to an anonymous namedtuple with
        # the same fields (still a pytree with attribute access).
        anon = _namedtuple("RestoredNamedTuple", entry.keys)
        return anon(*values)
