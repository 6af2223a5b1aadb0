"""TCP KV store: Python bindings for the native store server and client.

Counterpart of ``torchsnapshot_tpu/tpustore.py``: the coordination path of
multi-rank snapshots.  One process hosts a :class:`TCPStoreServer` (rank 0,
or a dedicated coordinator); every rank connects a :class:`TCPStore`
client.  Blocking GETs are served server-side on a condition variable, so
waiting costs no polling traffic, and ``delete_prefix`` lets the barrier's
key sweep keep the server's map bounded (torch's c10d stores cannot delete
by prefix).  The server and client live in the native library built from
``_native/tpustore.cc`` and speak the JAX package's wire protocol.
"""

from __future__ import annotations

import ctypes
import socket
import threading
from typing import List, Optional

from .dist_store import KVStore


class _NativeLib:
    _instance: Optional["_NativeLib"] = None

    def __init__(self) -> None:
        from ._native.build import get_native_lib_path

        lib = ctypes.CDLL(get_native_lib_path())
        lib.tpustore_server_start.restype = ctypes.c_void_p
        lib.tpustore_server_start.argtypes = [ctypes.c_int]
        lib.tpustore_server_port.restype = ctypes.c_int
        lib.tpustore_server_port.argtypes = [ctypes.c_void_p]
        lib.tpustore_server_stop.argtypes = [ctypes.c_void_p]
        lib.tpustore_client_connect.restype = ctypes.c_void_p
        lib.tpustore_client_connect.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.tpustore_client_set.restype = ctypes.c_int
        lib.tpustore_client_set.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_uint32,
        ]
        lib.tpustore_client_get.restype = ctypes.c_int
        lib.tpustore_client_get.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_int64,
        ]
        lib.tpustore_client_tryget.restype = ctypes.c_int
        lib.tpustore_client_tryget.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.tpustore_client_add.restype = ctypes.c_int
        lib.tpustore_client_add.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.tpustore_client_ping.restype = ctypes.c_int
        lib.tpustore_client_ping.argtypes = [ctypes.c_void_p]
        lib.tpustore_client_delete_prefix.restype = ctypes.c_int
        lib.tpustore_client_delete_prefix.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.tpustore_client_value_len.restype = ctypes.c_uint32
        lib.tpustore_client_value_len.argtypes = [ctypes.c_void_p]
        lib.tpustore_client_value.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.tpustore_client_close.argtypes = [ctypes.c_void_p]
        self.lib = lib

    @classmethod
    def get(cls) -> "_NativeLib":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance


class TCPStoreServer:
    """Hosts the store (rank 0 / a dedicated coordinator)."""

    def __init__(self, port: int = 0) -> None:
        self._lib = _NativeLib.get().lib
        self._handle = self._lib.tpustore_server_start(port)
        if not self._handle:
            raise RuntimeError(f"Failed to start tpustore server on port {port}")
        self.port = self._lib.tpustore_server_port(self._handle)
        try:
            self.host = socket.gethostbyname(socket.gethostname())
        except OSError:
            self.host = "127.0.0.1"

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def stop(self) -> None:
        if self._handle:
            self._lib.tpustore_server_stop(self._handle)
            self._handle = None


class TCPStore(KVStore):
    """Client over a small pool of TCP connections.

    The C client keeps the last response value in per-connection state
    (``last_value``) read back via ``value_len``/``value`` — two separate
    calls.  Sharing one connection across threads (the documented async
    pattern: a PendingSnapshot completion thread running LinearBarrier ops
    concurrently with main-thread collectives) would let a second request
    clobber ``last_value`` between a ``get()`` returning and its value read,
    and would also convoy every caller behind a server-side blocking GET.

    Every op therefore checks a connection out of a free pool (connecting on
    demand) and returns it afterwards: the request/value pair is private to
    the op, a blocking GET only occupies its own socket, connections are
    bounded by peak op concurrency rather than thread churn (each async
    snapshot spawns a fresh completion thread), and ``close()`` never frees a
    connection another thread is mid-request on — in-flight handles are
    closed at check-in.
    """

    def __init__(self, host: str, port: int, connect_timeout_s: float = 60.0) -> None:
        self._lib = _NativeLib.get().lib
        try:
            ip = socket.gethostbyname(host or "127.0.0.1")
        except socket.gaierror:
            ip = host
        self._ip = ip
        self._port = port
        self._connect_timeout_ms = int(connect_timeout_s * 1000)
        self._free: List[int] = []
        self._lock = threading.Lock()
        self._closed = False
        # Connect eagerly so construction fails fast if the server is absent.
        self._checkin(self._checkout())

    def _checkout(self) -> int:
        with self._lock:
            if self._closed:
                raise RuntimeError("TCPStore is closed")
            if self._free:
                return self._free.pop()
        handle = self._lib.tpustore_client_connect(
            self._ip.encode(), self._port, self._connect_timeout_ms
        )
        if not handle:
            raise RuntimeError(
                f"Failed to connect to tpustore at {self._ip}:{self._port}"
            )
        return handle

    def _checkin(self, handle: int) -> None:
        with self._lock:
            if not self._closed:
                self._free.append(handle)
                return
        self._lib.tpustore_client_close(handle)

    def _discard(self, handle: int) -> None:
        # After a failed op the connection's stream state is unknown: drop it.
        self._lib.tpustore_client_close(handle)

    def _read_value(self, handle: int) -> bytes:
        n = self._lib.tpustore_client_value_len(handle)
        buf = ctypes.create_string_buffer(n)
        if n:
            self._lib.tpustore_client_value(handle, buf)
        return buf.raw[:n]

    def set(self, key: str, value: bytes) -> None:
        handle = self._checkout()
        try:
            status = self._lib.tpustore_client_set(
                handle, key.encode(), value, len(value)
            )
        except BaseException:
            self._discard(handle)
            raise
        if status != 0:
            self._discard(handle)
            raise RuntimeError(f"tpustore set failed for {key}: status {status}")
        self._checkin(handle)

    def get(self, key: str, timeout_s=None) -> bytes:
        from .dist_store import resolve_wait_timeout_s

        handle = self._checkout()
        try:
            status = self._lib.tpustore_client_get(
                handle,
                key.encode(),
                int(resolve_wait_timeout_s(timeout_s) * 1000),
            )
            if status == 0:
                value = self._read_value(handle)
        except BaseException:
            self._discard(handle)
            raise
        if status == 2:
            # A timed-out GET leaves the connection in a clean state (the
            # server sent a complete response); reuse it.
            self._checkin(handle)
            raise TimeoutError(f"Timed out waiting for store key: {key}")
        if status != 0:
            self._discard(handle)
            raise RuntimeError(f"tpustore get failed for {key}: status {status}")
        self._checkin(handle)
        return value

    def try_get(self, key: str) -> Optional[bytes]:
        handle = self._checkout()
        try:
            status = self._lib.tpustore_client_tryget(handle, key.encode())
            if status == 0:
                value = self._read_value(handle)
        except BaseException:
            self._discard(handle)
            raise
        if status == 1:
            self._checkin(handle)
            return None
        if status != 0:
            self._discard(handle)
            raise RuntimeError(f"tpustore tryget failed for {key}: status {status}")
        self._checkin(handle)
        return value

    def add(self, key: str, amount: int) -> int:
        handle = self._checkout()
        result = ctypes.c_int64(0)
        try:
            status = self._lib.tpustore_client_add(
                handle, key.encode(), amount, ctypes.byref(result)
            )
        except BaseException:
            self._discard(handle)
            raise
        if status != 0:
            self._discard(handle)
            raise RuntimeError(f"tpustore add failed for {key}: status {status}")
        self._checkin(handle)
        return result.value

    def delete_prefix(self, prefix: str) -> int:
        handle = self._checkout()
        count = ctypes.c_int64(0)
        try:
            status = self._lib.tpustore_client_delete_prefix(
                handle, prefix.encode(), ctypes.byref(count)
            )
        except BaseException:
            self._discard(handle)
            raise
        if status != 0:
            self._discard(handle)
            raise RuntimeError(
                f"tpustore delete_prefix failed for {prefix}: status {status}"
            )
        self._checkin(handle)
        return count.value

    def wait_hint(self, iteration: int) -> None:
        # Blocking gets are served server-side; only `add`-polling loops spin.
        import time

        time.sleep(min(0.001 * (2 ** min(iteration, 6)), 0.05))

    def close(self) -> None:
        with self._lock:
            self._closed = True
            handles, self._free = self._free, []
        for handle in handles:
            self._lib.tpustore_client_close(handle)
