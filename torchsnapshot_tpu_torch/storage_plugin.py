"""URL → storage plugin resolver (counterpart of
``torchsnapshot_tpu/storage_plugin.py``).  This slice has ``fs`` (the
default when the URL has no scheme) and ``memory`` (a test fake), each
wrapped by the fault injector when ``TPUSNAP_FAULTS`` is set (faults.py);
cloud backends and entry-point plugins are later slices."""

from __future__ import annotations

from typing import Tuple

from . import knobs
from .io_types import StoragePlugin


def parse_url(url_path: str) -> Tuple[str, str]:
    """(protocol, root path)."""
    if "://" in url_path:
        protocol, path = url_path.split("://", 1)
        return protocol, path
    return "fs", url_path


def url_to_storage_plugin(url_path: str) -> StoragePlugin:
    plugin = _resolve_plugin(url_path)
    faults_spec = knobs.get_faults_spec()
    if faults_spec:
        from .faults import maybe_wrap_faults

        plugin = maybe_wrap_faults(plugin, faults_spec)
    return plugin


def _resolve_plugin(url_path: str) -> StoragePlugin:
    protocol, path = parse_url(url_path)
    if protocol == "fs":
        from .storage_plugins.fs import FSStoragePlugin

        return FSStoragePlugin(root=path)
    if protocol == "memory":
        from .storage_plugins.memory import MemoryStoragePlugin

        return MemoryStoragePlugin(root=path)
    raise RuntimeError(
        f"Unsupported protocol {protocol!r}: torchsnapshot_tpu_torch "
        "supports fs and memory storage"
    )
