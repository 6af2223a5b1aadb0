"""URL → storage plugin resolver (counterpart of
``torchsnapshot_tpu/storage_plugin.py``): ``fs`` (the default when the URL
has no scheme), ``s3``, ``gcs`` (``gs://`` or ``gcs://``) and ``memory`` (a
test fake) built in; third-party plugins through the
``torchsnapshot_tpu_torch.storage_plugins`` entry-point group.

``storage_options`` travel from the Snapshot APIs into the plugin's
constructor and override its environment configuration for that call.
``"faults"`` (a fault spec, as ``TPUSNAP_FAULTS``) is popped here, so a
plugin that refuses unknown keys never sees it, and the fault wrapper
composes over every backend alike.  ``fs`` and ``memory`` have no
tunables and refuse any other key.
"""

from __future__ import annotations

import inspect
from importlib.metadata import entry_points
from typing import Any, Dict, Optional, Tuple

from . import knobs
from .io_types import StoragePlugin

# The only alias table: incremental.py compares schemes through parse_url,
# so an alias cannot make the resolver and a comparison disagree.
PROTOCOL_ALIASES = {"gs": "gcs", "": "fs"}


def parse_url(url_path: str) -> Tuple[str, str]:
    """(normalized protocol, root path)."""
    if "://" in url_path:
        protocol, path = url_path.split("://", 1)
    else:
        protocol, path = "fs", url_path
    return PROTOCOL_ALIASES.get(protocol, protocol), path


def url_to_storage_plugin(
    url_path: str, storage_options: Optional[Dict[str, Any]] = None
) -> StoragePlugin:
    """The plugin for ``url_path``, wrapped by the fault injector when
    ``storage_options["faults"]`` or ``TPUSNAP_FAULTS`` names a spec."""
    faults_spec: Optional[str] = None
    if storage_options and "faults" in storage_options:
        storage_options = dict(storage_options)
        faults_spec = storage_options.pop("faults")
    if faults_spec is None:
        faults_spec = knobs.get_faults_spec()
    plugin = _resolve_plugin(url_path, storage_options)
    if faults_spec:
        from .faults import maybe_wrap_faults

        plugin = maybe_wrap_faults(plugin, faults_spec)
    return plugin


def _resolve_plugin(
    url_path: str, storage_options: Optional[Dict[str, Any]] = None
) -> StoragePlugin:
    protocol, path = parse_url(url_path)
    if protocol == "fs":
        from .storage_plugins.fs import FSStoragePlugin

        return FSStoragePlugin(root=path, storage_options=storage_options)
    if protocol == "s3":
        from .storage_plugins.s3 import S3StoragePlugin

        return S3StoragePlugin(root=path, storage_options=storage_options)
    if protocol == "gcs":
        from .storage_plugins.gcs import GCSStoragePlugin

        return GCSStoragePlugin(root=path, storage_options=storage_options)
    if protocol == "memory":
        from .storage_plugins.memory import MemoryStoragePlugin

        if storage_options:
            raise ValueError(
                f"memory accepts no storage_options, got {sorted(storage_options)}"
            )
        return MemoryStoragePlugin(root=path)
    for ep in entry_points(group="torchsnapshot_tpu_torch.storage_plugins"):
        if ep.name != protocol:
            continue
        cls = ep.load()
        if storage_options is None:
            return cls(path)
        # A signature check, not try/except TypeError: a TypeError raised
        # inside an options-aware constructor must surface, not retry with
        # the caller's options dropped.
        try:
            params = inspect.signature(cls).parameters
            accepts = "storage_options" in params or any(
                p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()
            )
        except (TypeError, ValueError):
            accepts = True  # uninspectable: assume an options-aware plugin
        if accepts:
            return cls(path, storage_options=storage_options)
        raise ValueError(
            f"Storage plugin {ep.name!r} does not accept "
            f"storage_options; remove them or upgrade the plugin"
        )

    raise RuntimeError(f"Unsupported protocol: {protocol}")
