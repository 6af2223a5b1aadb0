"""Google Cloud Storage plugin on the standard library (counterpart of
``torchsnapshot_tpu/storage_plugins/gcs.py``, which speaks the same JSON
API through ``google-resumable-media`` and ``requests``; this one needs no
package beyond Python's own, and ``google-auth`` only for credentials).

- transport: ``http.client``, one persistent connection per worker thread
  and host, reopened after any error and after a response whose body was
  not read to its end;
- ``write``: a resumable upload: POST to open the session, then PUTs of
  ``_CHUNK_SIZE_BYTES`` (a multiple of 256 KiB) with ``Content-Range``,
  each answered 308 with the persisted ``Range`` until the last is
  answered 200.  A chunk that fails transiently is followed by a
  ``bytes */total`` probe, and the upload resumes from the offset that
  persisted; a session that cannot be opened or probed restarts the whole
  upload.  Bodies are slices of the staged buffer, never joined into a
  copy;
- ``read``: ranged media GETs in chunks of ``_CHUNK_SIZE_BYTES``, streamed
  straight into the destination buffer; every response's
  ``x-goog-generation`` must equal the first one's, so an overwrite
  between two chunks raises instead of mixing two versions.  Reads of
  ``TPUSNAP_CLOUD_PARALLEL_MIN_BYTES`` or more fan out across ranged GETs
  pinned with ``generation=`` to the object's generation (``_ranged.py``).
  Reads are not hashed by the plugin: the consumer verifies the recorded
  digest itself;
- ``copy_from_sibling``: ``rewriteTo``, looping its ``rewriteToken`` for as
  many rounds as the copy takes (at most 1024, and only while the copied
  byte count grows), so incremental takes move no unchanged byte;
- ``delete``, ``exists`` (metadata GET), ``list_dir`` (``delimiter`` and
  ``pageToken``) and ``delete_dir``.

Transient failures (HTTP 408, 429, 5xx, dropped connections) are retried
under one deadline shared by every transfer of the plugin and refreshed by
any transfer's progress (:class:`_SharedDeadlineRetryStrategy`); a refused
response raises :class:`~torchsnapshot_tpu_torch.retry.HTTPStatusError`
carrying its status.

Endpoint: ``storage_options["endpoint"]`` or ``TPUSNAP_GCS_ENDPOINT`` (a
fake server, an emulator): requests go there, anonymous.  Without one, the
public endpoints with application-default credentials from ``google.auth``
(a bearer token, refreshed when it expires); without ``google.auth`` or
credentials the plugin refuses to start.  Object names are
``<prefix>/<path>``, as the JAX package's plugin writes them, so one root
is one layout whichever package wrote it.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import logging
import threading
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .. import knobs, phase_stats, retry
from ..telemetry import metrics as tmetrics
from ..io_types import ReadIO, StoragePlugin, WriteIO, contiguous

logger = logging.getLogger(__name__)

_CHUNK_SIZE_BYTES = 100 * 1024 * 1024  # resumable chunks and ranged GETs
_IO_THREADS = 16
# Children of io-pool reads (fan-out ranges): a parent blocks on its
# children, so they need a pool of their own, sized above the io pool so
# that 16 fanned-out parents are not capped below the 16 single streams
# they replace.
_CHUNK_THREADS = 32
_DEFAULT_DEADLINE_S = 600.0
_TIMEOUT_S = 300
_READ_PIECE_BYTES = 8 << 20  # cancel latency of a streamed GET
_REWRITE_MAX_ROUNDS = 1024
_UPLOAD_BASE = "https://www.googleapis.com"
_DOWNLOAD_BASE = "https://storage.googleapis.com"
_SCOPES = ("https://www.googleapis.com/auth/devstorage.read_write",)


class _SharedDeadlineRetryStrategy:
    """A deadline shared by all concurrent transfers, refreshed whenever any
    of them makes progress: a global stall fails fast, while steady
    collective progress never times out.  Progress also resets the attempt
    count of the backoff.  Each retry is counted (``retries``) and its
    sleep recorded in phase ``gcs_retry``."""

    def __init__(self, deadline_s: float = _DEFAULT_DEADLINE_S) -> None:
        self._deadline_s = deadline_s
        self._lock = threading.Lock()
        self._expires_at = time.monotonic() + deadline_s
        self._attempts = 0
        self.retries = 0

    def report_progress(self) -> None:
        with self._lock:
            self._expires_at = time.monotonic() + self._deadline_s
            self._attempts = 0

    def check_and_backoff(self, exc: BaseException, cancel=None) -> None:
        """Raise if the shared deadline expired, else sleep with jittered
        exponential backoff.  A set ``cancel`` event cuts the sleep short,
        so that a sibling fan-out range's hard failure is not held back a
        whole backoff (the caller's loop checks the event and raises)."""
        with self._lock:
            if time.monotonic() > self._expires_at:
                raise TimeoutError(
                    f"GCS transfers made no collective progress for {self._deadline_s}s"
                ) from exc
            self._attempts += 1
            self.retries += 1
            attempts = self._attempts
        tmetrics.record_retry("gcs")
        # Base 2 s capped at 32 s: the JAX package's ramp (±50% jitter);
        # TPUSNAP_RETRY_BASE_S overrides the base.
        backoff = retry.backoff_s(attempts, base_s=2.0, cap_s=32.0)
        logger.warning("GCS transient error (%r); retrying in %.1fs", exc, backoff)
        begin = time.monotonic()
        if cancel is not None:
            cancel.wait(backoff)
        else:
            time.sleep(backoff)
        phase_stats.add("gcs_retry", time.monotonic() - begin)


def _is_transient(exc: BaseException) -> bool:
    """The shared taxonomy (retry.is_transient): HTTP 408, 429 and 5xx
    through :class:`~torchsnapshot_tpu_torch.retry.HTTPStatusError`,
    dropped connections and timeouts."""
    return retry.is_transient(exc)


class _ViewWriter:
    """Fills a memoryview from response bodies, in order: downloads land
    straight in the restore target's memory."""

    def __init__(self, view: memoryview) -> None:
        self.view = view
        self._pos = 0

    def fill_from(self, resp: http.client.HTTPResponse, n: int, check=None) -> None:
        """Read ``n`` bytes of ``resp``'s body into the view at the current
        position, in pieces, calling ``check()`` before each."""
        if self._pos + n > self.view.nbytes:
            # RuntimeError: the extent check of a whole-object stream into
            # a fixed-size destination, the class every other extent
            # mismatch of the object-store plugins raises.
            raise RuntimeError(
                f"write of {n} bytes at {self._pos} past end of "
                f"{self.view.nbytes}-byte destination view"
            )
        end = self._pos + n
        while self._pos < end:
            if check is not None:
                check()
            got = resp.readinto(self.view[self._pos : min(self._pos + _READ_PIECE_BYTES, end)])
            if not got:
                raise http.client.IncompleteRead(b"", end - self._pos)
            self._pos += got

    def tell(self) -> int:
        return self._pos


class _GenerationGuard:
    """Detects an overwrite between the requests of one chunked download
    with no extra round trip: every media response carries
    ``x-goog-generation``, and a transfer whose responses disagree has
    mixed two object versions."""

    def __init__(self, path: str) -> None:
        self._path = path
        self._seen: Optional[str] = None

    def check(self, headers) -> None:
        gen = headers.get("x-goog-generation")
        if gen is None:
            return  # emulators may omit it; nothing to compare
        if self._seen is None:
            self._seen = gen
        elif gen != self._seen:
            raise RuntimeError(f"GCS object {self._path} changed mid-read (generation {self._seen} -> {gen})")

    def reset(self) -> None:
        # A restart reads every byte again, so only the new attempt's
        # responses need agree.
        self._seen = None


class _Response:
    """A response read to its end: status, headers and body."""

    __slots__ = ("status", "headers", "content")

    def __init__(self, status: int, headers, content: bytes) -> None:
        self.status = status
        self.headers = headers
        self.content = content


def _quote(name: str) -> str:
    return urllib.parse.quote(name, safe="")


def _content_range_total(value: Optional[str]) -> Optional[int]:
    """The object size of a ``Content-Range: bytes a-b/total`` header."""
    if not value or "/" not in value:
        return None
    total = value.rsplit("/", 1)[1].strip()
    return int(total) if total.isdigit() else None


def _default_credentials():
    """Application-default credentials from ``google.auth``."""
    try:
        import google.auth
    except ImportError as e:
        raise RuntimeError(
            "GCS storage requires application-default credentials, read through the "
            f"google-auth package, which is not installed ({e}); set TPUSNAP_GCS_ENDPOINT "
            "or storage_options['endpoint'] for an endpoint that takes anonymous requests"
        ) from e
    try:
        credentials, _ = google.auth.default(scopes=list(_SCOPES))
    except Exception as e:  # noqa: BLE001 — any failure means no credentials
        raise RuntimeError(
            f"GCS storage requires application-default credentials (google.auth.default failed: {e})"
        ) from e
    return credentials


def _token_transport():
    """A ``google.auth`` transport over ``http.client`` for token refreshes
    (the package's own transports need ``requests`` or ``urllib3``)."""
    import google.auth.exceptions
    import google.auth.transport as transport

    class _TokenResponse(transport.Response):
        def __init__(self, status: int, headers: Dict[str, str], data: bytes) -> None:
            self._status, self._headers, self._data = status, headers, data

        @property
        def status(self) -> int:
            return self._status

        @property
        def headers(self) -> Dict[str, str]:
            return self._headers

        @property
        def data(self) -> bytes:
            return self._data

    class _TokenRequest(transport.Request):
        def __call__(self, url, method="GET", body=None, headers=None, timeout=None, **kwargs):
            split = urllib.parse.urlsplit(url)
            cls = http.client.HTTPSConnection if split.scheme == "https" else http.client.HTTPConnection
            conn = cls(split.netloc, timeout=timeout or 120)
            target = split.path + (f"?{split.query}" if split.query else "")
            try:
                conn.request(method, target or "/", body=body, headers=dict(headers or {}))
                resp = conn.getresponse()
                return _TokenResponse(resp.status, dict(resp.getheaders()), resp.read())
            except (OSError, http.client.HTTPException) as e:
                raise google.auth.exceptions.TransportError(e) from e
            finally:
                conn.close()

    return _TokenRequest()


class GCSStoragePlugin(StoragePlugin):
    # Per-call configuration through storage_options; the key overrides its
    # environment variable for this plugin instance.
    _KNOWN_OPTIONS = frozenset({"endpoint"})

    def __init__(self, root: str, storage_options: Optional[Dict[str, str]] = None) -> None:
        options = dict(storage_options or {})
        unknown = set(options) - self._KNOWN_OPTIONS
        if unknown:
            raise ValueError(
                f"Unknown gcs storage_options: {sorted(unknown)} "
                f"(supported: {sorted(self._KNOWN_OPTIONS)})"
            )
        bucket, _, prefix = root.partition("/")
        self.bucket_name = bucket
        self.prefix = prefix.strip("/")
        endpoint = options.get("endpoint", knobs.get_gcs_endpoint())
        self._credentials = None
        if endpoint:
            # A fake server or an emulator: anonymous, both bases there.
            self._upload_base = self._download_base = endpoint.rstrip("/")
        else:
            self._upload_base, self._download_base = _UPLOAD_BASE, _DOWNLOAD_BASE
            self._credentials = _default_credentials()
            self._token_request = _token_transport()
        self._auth_lock = threading.Lock()
        self._retry = _SharedDeadlineRetryStrategy()
        # One connection per thread and host: http.client connections are
        # not thread-safe.  Every connection is also listed, so close() can
        # close them all.
        self._local = threading.local()
        self._conns: List[http.client.HTTPConnection] = []
        self._conns_lock = threading.Lock()
        # Built eagerly (a pool starts no thread before its first submit):
        # the getters run on worker threads, where lazy creation would race.
        self._executor = ThreadPoolExecutor(max_workers=_IO_THREADS, thread_name_prefix="gcs_io")
        self._chunk_executor = ThreadPoolExecutor(max_workers=_CHUNK_THREADS, thread_name_prefix="gcs_chunk")

    @property
    def retries(self) -> int:
        """Transient failures retried by this plugin."""
        return self._retry.retries

    # ---------------------------------------------------------- transport

    def _get_executor(self) -> ThreadPoolExecutor:
        return self._executor

    def _connection(self, https: bool, host: str) -> http.client.HTTPConnection:
        conns = getattr(self._local, "conns", None)
        if conns is None:
            conns = self._local.conns = {}
        conn = conns.get((https, host))
        if conn is None:
            cls = http.client.HTTPSConnection if https else http.client.HTTPConnection
            conn = conns[(https, host)] = cls(host, timeout=_TIMEOUT_S)
            with self._conns_lock:
                self._conns.append(conn)
        return conn

    def _authorize(self, method: str, url: str, headers: Dict[str, str]) -> None:
        if self._credentials is None:
            return
        with self._auth_lock:
            # Refreshes the token when it expired, then sets the bearer.
            self._credentials.before_request(self._token_request, method, url, headers)

    def _send(self, method: str, url: str, body=None, headers: Optional[Dict[str, str]] = None):
        """One attempt: (connection, response with its body unread)."""
        split = urllib.parse.urlsplit(url)
        target = split.path + (f"?{split.query}" if split.query else "")
        req_headers = dict(headers or {})
        self._authorize(method, url, req_headers)
        conn = self._connection(split.scheme == "https", split.netloc)
        try:
            conn.request(method, target, body=body, headers=req_headers)
            return conn, conn.getresponse()
        except BaseException:
            conn.close()  # reopened by the next request
            raise

    def _request(self, method: str, url: str, body=None, headers: Optional[Dict[str, str]] = None) -> _Response:
        """One attempt, its response read to its end."""
        conn, resp = self._send(method, url, body, headers)
        try:
            content = resp.read()
        except BaseException:
            conn.close()
            raise
        if not resp.isclosed():
            conn.close()
        return _Response(resp.status, resp.headers, content)

    @staticmethod
    def _refused(what: str, status: int, content: bytes = b"") -> retry.HTTPStatusError:
        text = content[:200].decode("utf-8", "replace")
        return retry.HTTPStatusError(f"GCS {what} failed: {status} {text}", status)

    def _checked(self, method: str, url: str, what: str, ok: Tuple[int, ...], body=None, headers=None) -> _Response:
        """One attempt; a status outside ``ok`` raises HTTPStatusError."""
        resp = self._request(method, url, body, headers)
        if resp.status not in ok:
            raise self._refused(what, resp.status, resp.content)
        return resp

    def _with_retry(self, fn, cancel=None):
        """``fn()`` with its transient failures retried under the shared
        deadline."""
        while True:
            try:
                out = fn()
            except Exception as e:  # noqa: BLE001 — classified below
                if not _is_transient(e):
                    raise
                self._retry.check_and_backoff(e, cancel)
                continue
            self._retry.report_progress()
            return out

    def _blob_url(self, path: str) -> str:
        """The object name of ``path``."""
        return f"{self.prefix}/{path}" if self.prefix else path

    def _object_url(self, path: str, media: bool = False) -> str:
        """JSON API URL of one object: its media download or its metadata."""
        kind = "/download/storage/v1/b/" if media else "/storage/v1/b/"
        url = f"{self._download_base}{kind}{self.bucket_name}/o/{_quote(self._blob_url(path))}"
        return url + "?alt=media" if media else url

    # ---------------------------------------------------------------- write

    def _blocking_write(self, path: str, buf) -> None:
        view = memoryview(contiguous(buf)).cast("B")
        begin = time.monotonic()
        while True:
            try:
                session = self._initiate_upload(path, view.nbytes)
                done, offset = False, 0
                while not done:
                    try:
                        done, offset = self._put_chunk(path, session, view, offset)
                    except Exception as e:  # noqa: BLE001 — classified below
                        if not _is_transient(e):
                            raise
                        self._retry.check_and_backoff(e)
                        # Ask how far the session got and resume there.
                        done, offset = self._recover(path, session, view.nbytes)
                        continue
                    self._retry.report_progress()
                break
            except Exception as e:  # noqa: BLE001 — classified below
                if not _is_transient(e):
                    raise
                self._retry.check_and_backoff(e)  # then a new session
        phase_stats.add("gcs_upload", time.monotonic() - begin, view.nbytes)

    def _initiate_upload(self, path: str, total: int) -> str:
        """POST the object's metadata; the session URI comes back in
        ``Location``."""
        url = f"{self._upload_base}/upload/storage/v1/b/{self.bucket_name}/o?uploadType=resumable"
        resp = self._checked(
            "POST",
            url,
            f"initiate upload of {path}",
            (200, 201),
            body=json.dumps({"name": self._blob_url(path)}).encode(),
            headers={
                "Content-Type": "application/json; charset=UTF-8",
                "X-Upload-Content-Type": "application/octet-stream",
                "X-Upload-Content-Length": str(total),
            },
        )
        location = resp.headers.get("Location")
        if not location:
            raise RuntimeError(f"GCS initiate upload of {path}: no session URI in Location")
        return location

    @staticmethod
    def _persisted(resp: _Response) -> int:
        """The bytes a 308 says persisted (``Range: bytes=0-N``)."""
        value = resp.headers.get("Range")
        if not value:
            return 0
        return int(value.rsplit("-", 1)[1]) + 1

    def _session_status(self, path: str, resp: _Response, total: int) -> Tuple[bool, int]:
        """(finished, next offset) from a session's answer."""
        if resp.status in (200, 201):
            return True, total
        if resp.status != 308:
            raise self._refused(f"upload of {path}", resp.status, resp.content)
        return False, self._persisted(resp)

    def _put_chunk(self, path: str, session: str, view: memoryview, offset: int) -> Tuple[bool, int]:
        """PUT the chunk at ``offset``: (finished, next offset)."""
        total = view.nbytes
        end = min(offset + _CHUNK_SIZE_BYTES, total)
        if offset >= total:
            # Nothing left to send (an empty object, or every byte already
            # persisted): finalize.  An open session's answer here is final.
            resp = self._request("PUT", session, headers={"Content-Range": f"bytes */{total}"})
            done, _ = self._session_status(path, resp, total)
            if not done:
                raise RuntimeError(f"GCS did not finalize the upload of {path} ({total} bytes sent)")
            return True, total
        with phase_stats.timed("gcs_chunk_put", end - offset):
            resp = self._request(
                "PUT", session, body=view[offset:end], headers={"Content-Range": f"bytes {offset}-{end - 1}/{total}"}
            )
        return self._session_status(path, resp, total)

    def _recover(self, path: str, session: str, total: int) -> Tuple[bool, int]:
        """The ``bytes */total`` probe: (finished, offset that persisted)."""
        resp = self._request("PUT", session, headers={"Content-Range": f"bytes */{total}"})
        return self._session_status(path, resp, total)

    async def write(self, write_io: WriteIO) -> None:
        await asyncio.get_running_loop().run_in_executor(
            self._executor, self._blocking_write, write_io.path, write_io.buf
        )

    # ----------------------------------------------------------------- read

    def _object_stat(self, path: str) -> Tuple[int, Optional[str]]:
        """(size, generation) from one metadata GET; the generation pins
        fan-out reads to one object version."""
        resp = self._with_retry(lambda: self._checked("GET", self._object_url(path), f"metadata GET {path}", (200, 404)))
        if resp.status != 200:
            raise RuntimeError(f"GCS metadata GET {path} failed: {resp.status}")
        meta = json.loads(resp.content)
        return int(meta.get("size", -1)), meta.get("generation") or None

    def _blocking_read(self, path: str, byte_range, into=None):
        from ._ranged import orchestrated_read

        begin = time.monotonic()
        ranges = []  # generation-pinned range GETs: the fan-out's

        def _stream(s, e, v, version=None, cancel=None):
            if version is not None:
                ranges.append(e - s)
            self._stream_download_into(path, s, e, v, version=version, cancel=cancel)

        out = orchestrated_read(
            byte_range=byte_range,
            into=into,
            chunk_executor=self._chunk_executor,
            stream_into=_stream,
            probe_stat=lambda: self._object_stat(path),
            single_read=lambda: self._download_range(path, byte_range),
            label=f"GCS object {path}",
        )
        if ranges:
            phase_stats.add("gcs_fanout", time.monotonic() - begin, sum(ranges))
        return out

    def _download_range(self, path: str, byte_range) -> memoryview:
        """``byte_range`` of the object (None: all of it) into a new buffer."""
        start, end = byte_range if byte_range is not None else (None, None)
        return self._stream_download_into(path, start, end, None)

    def _stream_download_into(
        self,
        path: str,
        start: Optional[int],
        end: Optional[int],
        view: Optional[memoryview],
        version: Optional[str] = None,
        cancel=None,
    ) -> memoryview:
        """One download streamed straight into ``view``, which it must fill
        exactly, in ranged GETs of ``_CHUNK_SIZE_BYTES``; ``start``/``end``
        (exclusive) select a range, ``(None, None)`` the whole object.
        ``view=None`` allocates the buffer once the first response gives
        the size.  ``version`` pins the generation: a superseded object
        fails the read instead of mixing two versions."""
        url = self._object_url(path, media=True)
        if version is not None:
            url += f"&generation={_quote(version)}"
        guard = _GenerationGuard(path)
        while True:
            self._check_cancel(path, cancel)
            try:
                return self._download_attempt(path, url, start, end, view, guard, cancel)
            except Exception as e:  # noqa: BLE001 — classified below
                if version is not None and getattr(e, "status", None) == 404:
                    # The pinned generation is gone: name it, rather than a
                    # bare "not found" that reads like data loss.
                    raise RuntimeError(
                        f"GCS object {path} changed mid-read (generation {version} superseded or deleted)"
                    ) from e
                if not _is_transient(e):
                    raise
                self._retry.check_and_backoff(e, cancel)
                guard.reset()

    @staticmethod
    def _check_cancel(path: str, cancel) -> None:
        if cancel is not None and cancel.is_set():
            # A sibling fan-out range failed hard: abandon this one.
            raise RuntimeError(f"GCS read of {path} abandoned: a sibling chunk failed")

    def _download_attempt(self, path, url, start, end, view, guard, cancel) -> memoryview:
        first = 0 if start is None else start
        pos, stop = first, end  # absolute offsets; stop None: the object's end
        writer = None if view is None else _ViewWriter(view)
        while stop is None or pos < stop:
            self._check_cancel(path, cancel)
            last = pos + _CHUNK_SIZE_BYTES - 1
            if stop is not None:
                last = min(last, stop - 1)
            begin = time.monotonic()
            conn, resp = self._send("GET", url, headers={"Range": f"bytes={pos}-{last}"})
            try:
                if resp.status == 416 and stop is None and pos == 0:
                    stop = 0  # an empty object has no byte to range over
                elif resp.status not in (200, 206):
                    raise self._refused(f"GET {path}", resp.status, resp.read(200))
                else:
                    n = int(resp.headers.get("Content-Length", -1))
                    size = _content_range_total(resp.headers.get("Content-Range"))
                    if resp.status == 200:
                        # The whole object: right only for a read from 0.
                        if pos != 0:
                            raise RuntimeError(f"GCS ignored Range for {path} (200 for bytes={pos}-{last})")
                        size = n
                    if n < 0 or size is None:
                        raise RuntimeError(f"GCS GET {path}: no Content-Length or Content-Range")
                    if stop is None:
                        stop = size
                    if writer is None:
                        writer = _ViewWriter(memoryview(np.empty(max(stop - first, 0), dtype=np.uint8)))
                    guard.check(resp.headers)
                    writer.fill_from(resp, n, check=lambda: self._check_cancel(path, cancel))
                    phase_stats.add("gcs_get", time.monotonic() - begin, n)
                    pos += n
                    if n == 0 or pos >= size:
                        break  # the object ends here
            finally:
                # A body not read to its end leaves the connection unusable.
                if not resp.isclosed():
                    conn.close()
            self._retry.report_progress()
        if writer is None:  # an empty object or range
            writer = _ViewWriter(memoryview(np.empty(0, dtype=np.uint8)))
        expected = writer.view.nbytes
        if writer.tell() != expected:
            raise RuntimeError(f"GCS read of {path} returned {writer.tell()} bytes, expected {expected}")
        return writer.view

    async def read(self, read_io: ReadIO) -> None:
        read_io.buf = await asyncio.get_running_loop().run_in_executor(
            self._executor, self._blocking_read, read_io.path, read_io.byte_range, read_io.into
        )

    # ------------------------------------------------------------- metadata

    async def delete(self, path: str) -> None:
        def _delete() -> None:
            self._with_retry(lambda: self._checked("DELETE", self._object_url(path), f"DELETE {path}", (200, 204, 404)))

        await asyncio.get_running_loop().run_in_executor(self._executor, _delete)

    async def exists(self, path: str) -> bool:
        def _probe() -> bool:
            # Metadata GET: one round trip, no object bytes.
            resp = self._with_retry(lambda: self._checked("GET", self._object_url(path), f"GET {path}", (200, 404)))
            return resp.status == 200

        return await asyncio.get_running_loop().run_in_executor(self._executor, _probe)

    def _list(self, prefix: str, delimiter: bool) -> Iterator[Tuple[List[str], List[str]]]:
        """Pages of (object names, prefixes) under ``prefix``."""
        token: Optional[str] = None
        while True:
            params = {"prefix": prefix}
            if delimiter:
                params["delimiter"] = "/"
            if token:
                params["pageToken"] = token
            url = f"{self._download_base}/storage/v1/b/{self.bucket_name}/o?{urllib.parse.urlencode(params)}"
            resp = self._with_retry(lambda: self._checked("GET", url, "LIST", (200,)))
            data = json.loads(resp.content)
            yield [item["name"] for item in data.get("items", [])], list(data.get("prefixes", []))
            token = data.get("nextPageToken")
            if not token:
                return

    def _dir_prefix(self, path: str) -> str:
        name = self._blob_url(path).strip("/")
        return f"{name}/" if name else ""

    async def list_dir(self, path: str) -> List[str]:
        def _list_dir() -> List[str]:
            prefix = self._dir_prefix(path)
            children = set()
            for names, prefixes in self._list(prefix, delimiter=True):
                children.update(n[len(prefix) :] for n in names)
                children.update(p[len(prefix) :].rstrip("/") for p in prefixes)
            return sorted(c for c in children if c)

        return await asyncio.get_running_loop().run_in_executor(self._executor, _list_dir)

    async def delete_dir(self, path: str) -> None:
        def _delete_dir() -> None:
            base = f"{self._download_base}/storage/v1/b/{self.bucket_name}/o/"
            for names, _ in self._list(self._dir_prefix(path), delimiter=False):
                for name in names:
                    self._with_retry(lambda: self._checked("DELETE", base + _quote(name), f"DELETE {name}", (200, 204, 404)))

        await asyncio.get_running_loop().run_in_executor(self._executor, _delete_dir)

    # ------------------------------------------------------ server-side copy

    async def copy_from_sibling(self, src_root: str, path: str) -> bool:
        src_bucket, _, src_prefix = src_root.partition("/")
        if src_bucket != self.bucket_name:
            return False  # copies are same-bucket only: write normally

        def _copy() -> bool:
            # objects.rewrite, not copyTo: one copyTo call can time out on a
            # multi-GB source, while rewrite answers done=false with a
            # rewriteToken for as many continuation calls as the copy needs.
            src_prefix_s = src_prefix.strip("/")
            src_name = f"{src_prefix_s}/{path}" if src_prefix_s else path
            base_url = (
                f"{self._download_base}/storage/v1/b/{self.bucket_name}/o/{_quote(src_name)}"
                f"/rewriteTo/b/{self.bucket_name}/o/{_quote(self._blob_url(path))}"
            )
            begin = time.monotonic()
            token: Optional[str] = None
            last_total = -1
            # Round cap: an endpoint replaying done=false forever must fall
            # back to a normal write, not hang the take.
            for _ in range(_REWRITE_MAX_ROUNDS):
                url = base_url + (f"?rewriteToken={_quote(token)}" if token else "")
                try:
                    resp = self._checked("POST", url, f"rewrite of {path}", (200, 404))
                    if resp.status == 404:
                        return False
                    payload = json.loads(resp.content)
                except Exception as e:  # noqa: BLE001 — classified below
                    if not _is_transient(e):
                        raise
                    self._retry.check_and_backoff(e)
                    continue
                if payload.get("done", True):
                    self._retry.report_progress()
                    size = payload.get("objectSize") or payload.get("resource", {}).get("size") or 0
                    phase_stats.add("gcs_copy", time.monotonic() - begin, int(size))
                    return True
                token = payload.get("rewriteToken")
                if not token:
                    return False  # a malformed continuation: write normally
                # Only real progress refreshes the shared deadline, so a
                # replayed done=false runs into the no-progress timeout.
                # This backoff sits outside the try: its TimeoutError is
                # the give-up signal and must propagate (the incremental
                # wrapper then writes normally).
                total = int(payload.get("totalBytesRewritten", 0) or 0)
                if total > last_total:
                    last_total = total
                    self._retry.report_progress()
                else:
                    self._retry.check_and_backoff(RuntimeError("rewrite made no progress"))
            return False

        return await asyncio.get_running_loop().run_in_executor(self._executor, _copy)

    # ---------------------------------------------------------------- close

    async def close(self) -> None:
        """Wait for every worker to finish, then close every connection, so
        no thread the plugin started and no socket it opened outlives it."""
        for executor in (self._executor, self._chunk_executor):
            executor.shutdown(wait=True)
        with self._conns_lock:
            conns, self._conns = self._conns, []
        for conn in conns:
            conn.close()
