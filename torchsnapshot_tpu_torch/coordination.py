"""Rank discovery and the coordination-store bootstrap over torch.distributed.

Counterpart of ``torchsnapshot_tpu/coordination.py``, where the JAX package
reads rank and world size from ``jax.distributed`` and rides the JAX
coordination service.  Here:

- :func:`torch_process_info` reads rank and world size from
  ``torch.distributed`` once it is initialized, else from the launcher's
  ``TPUSNAP_RANK``/``TPUSNAP_WORLD_SIZE``;
- :func:`bootstrap_store` is the last fallback of
  ``dist_store.get_or_create_store``: rank 0 starts the native TCP store
  server on a free port and sends ``host:port`` to every rank with
  ``torch.distributed.broadcast_object_list`` over the default group (the
  free-port broadcast of upstream torchsnapshot's ``dist_store.py``).

After the bootstrap the library makes no call into ``torch.distributed``:
every object collective and barrier runs over the store (pg_wrapper.py).
"""

from __future__ import annotations

import socket
from typing import List, Optional, Tuple

import torch

from . import knobs
from .dist_store import KVStore

# Servers this process started as rank 0 of a bootstrap; they live as long
# as the process group they serve.
_SERVERS: List[object] = []


def torch_distributed_initialized() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def torch_process_info() -> Optional[Tuple[int, int]]:
    """(rank, world_size) from torch.distributed when it is initialized,
    else from ``TPUSNAP_RANK``/``TPUSNAP_WORLD_SIZE``, else None."""
    if torch_distributed_initialized():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    rank, world_size = knobs.get_env_rank(), knobs.get_env_world_size()
    if rank is not None and world_size is not None:
        return rank, world_size
    return None


def _own_host() -> Optional[str]:
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return None


def bootstrap_store(rank: int, world_size: int) -> Optional[KVStore]:
    """A TCP store served by rank 0, its address broadcast over the default
    torch.distributed group; None when torch.distributed is not
    initialized.  Collective: every rank of the default group calls it."""
    if not torch_distributed_initialized():
        return None
    from .tpustore import TCPStore, TCPStoreServer

    addr: List[Optional[str]] = [None]
    if rank == 0:
        # A re-created default group gets a fresh server; the previous
        # group's server has no clients left.
        while _SERVERS:
            _SERVERS.pop().stop()  # type: ignore[attr-defined]
        server = TCPStoreServer(0)
        _SERVERS.append(server)
        addr[0] = server.addr
    torch.distributed.broadcast_object_list(addr, src=0)
    assert addr[0] is not None
    host, _, port = addr[0].rpartition(":")
    if host == _own_host():
        host = "127.0.0.1"  # the server is on this host
    return TCPStore(host, int(port))


def broadcast_incarnation(rank: int) -> str:
    """A short id drawn by rank 0 and shared over the default group: it
    namespaces a process group's collective keys, so a group that is
    destroyed and made again over the same store never reads the keys of
    its predecessor."""
    import uuid

    obj: List[Optional[str]] = [uuid.uuid4().hex[:12] if rank == 0 else None]
    torch.distributed.broadcast_object_list(obj, src=0)
    assert obj[0] is not None
    return obj[0]
