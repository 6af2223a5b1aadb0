"""S3 storage plugin on the standard library (counterpart of
``torchsnapshot_tpu/storage_plugins/s3.py``, which speaks the same REST
API over ``requests``; this one needs no package beyond Python's own).

- transport: ``http.client``, one persistent connection per worker thread,
  reopened after any error and after a response whose body was not read to
  its end; requests are signed with AWS Signature Version 4
  (``hashlib``/``hmac``, unsigned payload, so no extra pass over the bytes)
  when credentials are set, and go unsigned otherwise (local fakes);
- ``write``: one PUT of the staged buffer, sent from its memory with no
  copy, or above ``TPUSNAP_S3_MULTIPART_THRESHOLD_BYTES`` (5 GiB, AWS's
  single-PUT ceiling) a multipart upload whose parts go up in parallel,
  aborted on any failure;
- ``read``: HTTP ``Range`` with the inclusive-end correction; into-reads
  stream straight into the destination buffer, and reads of
  ``TPUSNAP_CLOUD_PARALLEL_MIN_BYTES`` or more fan out across ranged GETs
  pinned to the object's ETag (``_ranged.py``), so an overwrite between
  ranges raises instead of mixing two versions.  Reads are not hashed by
  the plugin: the consumer verifies the recorded digest itself;
- ``copy_from_sibling``: a server-side CopyObject, or UploadPartCopy for
  sources over 5 GiB, so incremental takes move no unchanged byte;
- ``delete``, ``exists`` (HEAD), ``list_dir`` (paginated ListObjectsV2) and
  ``delete_dir`` (a bounded fan-out of DELETEs).

Transient failures (HTTP 408, 429, 5xx, dropped connections) are retried
up to five attempts with the shared backoff (retry.py); a request that
exhausts them raises a terminal ``RuntimeError``, and a refused response
raises :class:`~torchsnapshot_tpu_torch.retry.HTTPStatusError` carrying its
status.

Endpoint: ``storage_options["endpoint"]`` or ``TPUSNAP_S3_ENDPOINT`` (path
style, ``<endpoint>/<bucket>/<key>``: a fake server, MinIO, R2), else
``https://<bucket>.s3.<region>.amazonaws.com``.  Credentials:
``storage_options`` ``access_key``/``secret_key``/``session_token`` or
``AWS_ACCESS_KEY_ID``/``AWS_SECRET_ACCESS_KEY``/``AWS_SESSION_TOKEN``;
region: ``region`` or ``AWS_REGION``/``AWS_DEFAULT_REGION`` (us-east-1).
Object keys are ``<prefix>/<path>``, as the JAX package's plugin writes
them, so one root is one layout whichever package wrote it.
"""

from __future__ import annotations

import asyncio
import datetime
import hashlib
import hmac
import http.client
import os
import threading
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from typing import Dict, List, Optional, Tuple
from xml.etree import ElementTree

import numpy as np

from .. import knobs, phase_stats, retry
from ..telemetry import metrics as tmetrics
from ..io_types import ReadIO, StoragePlugin, WriteIO, contiguous

_IO_THREADS = 16
# Children of io-pool reads and writes (fan-out ranges, multipart parts):
# a parent blocks on its children, so they need a pool of their own, sized
# above the io pool so that 16 fanned-out parents are not capped below the
# 16 single streams they replace.
_CHUNK_THREADS = 32
_DELETE_THREADS = 8
_MAX_ATTEMPTS = 5
_BACKOFF_BASE_S = 0.2
_BACKOFF_CAP_S = 2.0
_TIMEOUT_S = 300
_READ_PIECE_BYTES = 8 << 20  # cancel latency of a streamed GET
_UNSIGNED_PAYLOAD = "UNSIGNED-PAYLOAD"
_NS = "{http://s3.amazonaws.com/doc/2006-03-01/}"

# AWS rejects single PUTs over 5 GB; payloads past the threshold go up as
# multipart uploads instead.
_DEFAULT_MULTIPART_THRESHOLD = 5 * 1024 * 1024 * 1024
_DEFAULT_MULTIPART_PART = 256 * 1024 * 1024  # AWS bounds: >=5 MB, <=10k parts

TRANSIENT_STATUS = retry.TRANSIENT_HTTP_STATUS


def _hmac_sha256(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


class _SigV4:
    """AWS Signature Version 4 for S3 with an unsigned payload."""

    def __init__(self, access_key: str, secret_key: str, session_token: Optional[str], region: str) -> None:
        self._access_key = access_key
        self._secret_key = secret_key
        self._session_token = session_token
        self._region = region

    def sign(self, method: str, host: str, target: str, headers: Dict[str, str], now=None) -> None:
        """Add the signature headers for a request of ``target`` (path and
        query, already percent-encoded) on ``host``."""
        path, _, query = target.partition("?")
        now = now or datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        date_stamp = now.strftime("%Y%m%d")
        headers["host"] = host
        headers["x-amz-date"] = amz_date
        headers["x-amz-content-sha256"] = _UNSIGNED_PAYLOAD
        if self._session_token:
            headers["x-amz-security-token"] = self._session_token
        lowered = {k.lower(): str(v).strip() for k, v in headers.items()}
        signed_names = sorted(lowered)
        canonical_headers = "".join(f"{name}:{lowered[name]}\n" for name in signed_names)
        canonical_query = "&".join(
            sorted(
                f"{urllib.parse.quote(k, safe='')}={urllib.parse.quote(v, safe='')}"
                for k, v in urllib.parse.parse_qsl(query, keep_blank_values=True)
            )
        )
        canonical_request = "\n".join(
            [
                method,
                # S3 forbids double-encoding the canonical path: the request
                # path is already percent-encoded, so it is used verbatim.
                path or "/",
                canonical_query,
                canonical_headers,
                ";".join(signed_names),
                _UNSIGNED_PAYLOAD,
            ]
        )
        scope = f"{date_stamp}/{self._region}/s3/aws4_request"
        string_to_sign = "\n".join(
            ["AWS4-HMAC-SHA256", amz_date, scope, hashlib.sha256(canonical_request.encode()).hexdigest()]
        )
        key = _hmac_sha256(f"AWS4{self._secret_key}".encode(), date_stamp)
        for part in (self._region, "s3", "aws4_request"):
            key = _hmac_sha256(key, part)
        signature = hmac.new(key, string_to_sign.encode(), hashlib.sha256).hexdigest()
        headers["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self._access_key}/{scope}, "
            f"SignedHeaders={';'.join(signed_names)}, Signature={signature}"
        )


class _Response:
    """A response read to its end: status, headers and body."""

    __slots__ = ("status", "headers", "content")

    def __init__(self, status: int, headers, content: bytes) -> None:
        self.status = status
        self.headers = headers
        self.content = content

    @property
    def text(self) -> str:
        return self.content[:200].decode("utf-8", "replace")


class S3StoragePlugin(StoragePlugin):
    # Per-call configuration through storage_options; each key overrides its
    # environment variable for this plugin instance.
    _KNOWN_OPTIONS = frozenset({"endpoint", "region", "access_key", "secret_key", "session_token"})

    # AWS CopyObject rejects sources over 5 GB; larger objects are copied
    # server-side part by part with UploadPartCopy.
    _COPY_MAX_BYTES = 5 * 1024 * 1024 * 1024
    _COPY_PART_BYTES = 1024 * 1024 * 1024

    def __init__(self, root: str, storage_options: Optional[Dict[str, str]] = None) -> None:
        options = dict(storage_options or {})
        unknown = set(options) - self._KNOWN_OPTIONS
        if unknown:
            raise ValueError(
                f"Unknown s3 storage_options: {sorted(unknown)} "
                f"(supported: {sorted(self._KNOWN_OPTIONS)})"
            )
        bucket, _, prefix = root.partition("/")
        self.bucket = bucket
        self.prefix = prefix.strip("/")
        region = options.get("region", os.environ.get("AWS_REGION", os.environ.get("AWS_DEFAULT_REGION", "us-east-1")))
        endpoint = options.get("endpoint", knobs.get_s3_endpoint())
        if endpoint:
            # Path-style addressing for custom endpoints.
            parsed = urllib.parse.urlsplit(endpoint.rstrip("/"))
            self._https = parsed.scheme == "https"
            self._host = parsed.netloc
            self._base_path = f"{parsed.path}/{bucket}"
        else:
            self._https = True
            self._host = f"{bucket}.s3.{region}.amazonaws.com"
            self._base_path = ""
        access_key = options.get("access_key", os.environ.get("AWS_ACCESS_KEY_ID"))
        secret_key = options.get("secret_key", os.environ.get("AWS_SECRET_ACCESS_KEY"))
        self._signer: Optional[_SigV4] = None
        if access_key and secret_key:
            self._signer = _SigV4(
                access_key, secret_key, options.get("session_token", os.environ.get("AWS_SESSION_TOKEN")), region
            )
        # One connection per thread: http.client connections are not
        # thread-safe.  Every connection is also listed, so close() can
        # close them all.
        self._local = threading.local()
        self._conns: List[http.client.HTTPConnection] = []
        self._conns_lock = threading.Lock()
        self.retries = 0  # transient failures retried by this plugin
        # Built eagerly (a pool starts no thread before its first submit):
        # the getters run on worker threads, where lazy creation would race.
        self._executor = ThreadPoolExecutor(max_workers=_IO_THREADS, thread_name_prefix="s3_io")
        self._chunk_executor = ThreadPoolExecutor(max_workers=_CHUNK_THREADS, thread_name_prefix="s3_chunk")
        self._delete_executor = ThreadPoolExecutor(max_workers=_DELETE_THREADS, thread_name_prefix="s3_del")

    # ---------------------------------------------------------- transport

    def _get_executor(self) -> ThreadPoolExecutor:
        return self._executor

    def _connection(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            cls = http.client.HTTPSConnection if self._https else http.client.HTTPConnection
            conn = cls(self._host, timeout=_TIMEOUT_S)
            self._local.conn = conn
            with self._conns_lock:
                self._conns.append(conn)
        return conn

    def _key(self, path: str) -> str:
        return f"{self.prefix}/{path}" if self.prefix else path

    def _target(self, key: str, query: str = "") -> str:
        target = f"{self._base_path}/{urllib.parse.quote(key, safe='/')}"
        return f"{target}?{query}" if query else target

    def _send(self, method: str, target: str, body=None, headers: Optional[Dict[str, str]] = None):
        """One attempt: (connection, response with its body unread)."""
        req_headers = dict(headers or {})
        if self._signer is not None:
            self._signer.sign(method, self._host, target, req_headers)
        conn = self._connection()
        try:
            conn.request(method, target, body=body, headers=req_headers)
            return conn, conn.getresponse()
        except BaseException:
            conn.close()  # reopened by the next request
            raise

    def _backoff(self, attempt: int, cancel=None) -> None:
        with self._conns_lock:
            self.retries += 1
        tmetrics.record_retry("s3")
        retry.sleep_backoff(attempt, cancel=cancel, base_s=_BACKOFF_BASE_S, cap_s=_BACKOFF_CAP_S)

    def _request(self, method: str, target: str, body=None, headers: Optional[Dict[str, str]] = None) -> _Response:
        """A request read to its end, with transient failures retried."""
        last_exc: Optional[BaseException] = None
        for attempt in range(_MAX_ATTEMPTS):
            if attempt:
                self._backoff(attempt)
            conn = None
            try:
                conn, resp = self._send(method, target, body, headers)
                content = resp.read()
            except (OSError, http.client.HTTPException) as e:
                if conn is not None:
                    conn.close()
                if not retry.is_transient(e):
                    raise
                last_exc = e
                continue
            if not resp.isclosed():
                conn.close()
            if resp.status in TRANSIENT_STATUS:
                last_exc = retry.HTTPStatusError(f"S3 transient {resp.status}: {content[:200]!r}", resp.status)
                continue
            return _Response(resp.status, resp.headers, content)
        raise RuntimeError(f"S3 {method} {target} failed after {_MAX_ATTEMPTS} attempts") from last_exc

    @staticmethod
    def _refused(what: str, resp: _Response) -> retry.HTTPStatusError:
        return retry.HTTPStatusError(f"S3 {what} failed: {resp.status} {resp.text}", resp.status)

    # ---------------------------------------------------------------- write

    async def write(self, write_io: WriteIO) -> None:
        def _put() -> None:
            body = memoryview(contiguous(write_io.buf)).cast("B")
            threshold = knobs.get_s3_multipart_threshold_bytes(_DEFAULT_MULTIPART_THRESHOLD)
            if body.nbytes > threshold:
                self._multipart_put(self._key(write_io.path), body)
                return
            with phase_stats.timed("s3_put", body.nbytes):
                resp = self._request("PUT", self._target(self._key(write_io.path)), body=body)
            if resp.status not in (200, 201):
                raise self._refused(f"PUT {write_io.path}", resp)

        await asyncio.get_running_loop().run_in_executor(self._executor, _put)

    def _initiate_multipart(self, key: str) -> str:
        """POST ?uploads → the url-quoted UploadId."""
        resp = self._request("POST", self._target(key, "uploads"))
        if resp.status != 200:
            raise self._refused(f"initiate multipart for {key}", resp)
        tree = ElementTree.fromstring(resp.content)
        upload_el = tree.find(f"{_NS}UploadId")
        if upload_el is None:  # fakes may omit the namespace
            upload_el = tree.find("UploadId")
        if upload_el is None or not upload_el.text:
            raise RuntimeError(f"S3 initiate multipart for {key}: no UploadId")
        return urllib.parse.quote(upload_el.text, safe="")

    def _complete_multipart(self, key: str, upload_id: str, etags) -> None:
        complete = (
            "<CompleteMultipartUpload>"
            + "".join(f"<Part><PartNumber>{n}</PartNumber><ETag>{etag}</ETag></Part>" for n, etag in etags)
            + "</CompleteMultipartUpload>"
        ).encode()
        resp = self._request("POST", self._target(key, f"uploadId={upload_id}"), body=complete)
        # Complete may answer 200 with an <Error> body: require the result.
        if resp.status != 200 or b"CompleteMultipartUploadResult" not in resp.content:
            raise self._refused(f"complete multipart for {key}", resp)

    def _abort_multipart(self, key: str, upload_id: str) -> None:
        """Best effort: an upload left open keeps its parts billed."""
        try:
            self._request("DELETE", self._target(key, f"uploadId={upload_id}"))
        except Exception:  # noqa: BLE001 — the upload's own error is what raises
            pass

    def _multipart_put(self, key: str, body: memoryview) -> None:
        """Multipart upload: the parts are slices of the staged buffer (no
        copy), sent in parallel on the child pool, each through its own
        retries; any failure waits for the parts in flight and aborts."""
        part_size = knobs.get_s3_multipart_part_bytes(_DEFAULT_MULTIPART_PART)
        part_size = max(part_size, -(-body.nbytes // 10000))  # AWS: at most 10k parts
        begin = time.monotonic()
        upload_id = self._initiate_multipart(key)

        def _part(number: int, offset: int) -> Tuple[int, str]:
            part = body[offset : offset + part_size]
            with phase_stats.timed("s3_multipart_part", part.nbytes):
                resp = self._request(
                    "PUT", self._target(key, f"partNumber={number}&uploadId={upload_id}"), body=part
                )
            if resp.status != 200:
                raise self._refused(f"part {number} of {key}", resp)
            return number, resp.headers.get("ETag", "")

        futures = [
            self._chunk_executor.submit(_part, number, offset)
            for number, offset in enumerate(range(0, body.nbytes, part_size), start=1)
        ]
        try:
            etags = [f.result() for f in futures]
            self._complete_multipart(key, upload_id, etags)
        except BaseException:
            for f in futures:
                f.cancel()
            futures_wait(futures)
            self._abort_multipart(key, upload_id)
            raise
        phase_stats.add("s3_multipart", time.monotonic() - begin, body.nbytes)

    # ----------------------------------------------------------------- read

    def _stream_get_into(
        self,
        path: str,
        start: Optional[int],
        end: Optional[int],
        view: Optional[memoryview],
        version: Optional[str] = None,
        cancel=None,
    ) -> memoryview:
        """One GET streamed straight into ``view``, which it must fill
        exactly; ``start``/``end`` (exclusive) select a range, ``(None,
        None)`` the whole object.  ``view=None`` allocates the buffer from
        the response's Content-Length.  ``version`` pins the ETag: an
        overwritten object fails (412) instead of mixing two versions.

        Owns its retry loop: a transient error can surface mid-body."""
        target = self._target(self._key(path))
        last_exc: Optional[BaseException] = None
        for attempt in range(_MAX_ATTEMPTS):
            if cancel is not None and cancel.is_set():
                raise RuntimeError(f"S3 GET {path} abandoned: a sibling chunk failed")
            if attempt:
                self._backoff(attempt, cancel=cancel)
            headers = {}
            if start is not None:
                headers["Range"] = f"bytes={start}-{end - 1}"  # inclusive end
            if version is not None:
                headers["If-Match"] = version
            conn = None
            resp = None
            begin = time.monotonic()
            try:
                conn, resp = self._send("GET", target, headers=headers)
                if resp.status == 412:
                    raise RuntimeError(f"S3 object {path} changed mid-read (ETag no longer {version})")
                if resp.status in TRANSIENT_STATUS:
                    last_exc = retry.HTTPStatusError(f"S3 transient {resp.status}", resp.status)
                    continue
                if resp.status not in (200, 206):
                    raise self._refused(f"GET {path}", _Response(resp.status, resp.headers, resp.read(200)))
                clen = resp.headers.get("Content-Length")
                if view is None:
                    if clen is None:
                        raise RuntimeError(f"S3 GET {path}: no Content-Length")
                    view = memoryview(np.empty(int(clen), dtype=np.uint8))
                expected = view.nbytes
                if resp.status == 200 and start is not None:
                    # A server may ignore Range and answer 200 with the whole
                    # object: acceptable only for a range that is exactly
                    # the whole object.
                    if start > 0 or clen is None or int(clen) != expected:
                        raise RuntimeError(f"S3 ignored Range for {path} (200 for bytes={start}-{end - 1})")
                if clen is not None and int(clen) != expected:
                    raise RuntimeError(
                        f"S3 GET {path} returned {clen} bytes, expected {expected} (status {resp.status})"
                    )
                filled = 0
                while filled < expected:
                    if cancel is not None and cancel.is_set():
                        raise RuntimeError(f"S3 GET {path} abandoned: a sibling chunk failed")
                    n = resp.readinto(view[filled : min(filled + _READ_PIECE_BYTES, expected)])
                    if not n:
                        break
                    filled += n
                if filled != expected:
                    raise http.client.IncompleteRead(b"", expected - filled)
                if not resp.isclosed() and resp.read(1):
                    raise RuntimeError(f"S3 GET {path} exceeded the expected {expected} bytes")
                phase_stats.add("s3_get", time.monotonic() - begin, expected)
                return view
            except (OSError, http.client.HTTPException) as e:
                if not retry.is_transient(e):
                    raise
                last_exc = e
                continue
            finally:
                # A body not read to its end leaves the connection unusable.
                if resp is not None and not resp.isclosed():
                    conn.close()
        raise RuntimeError(f"S3 GET {path} failed after {_MAX_ATTEMPTS} attempts") from last_exc

    def _object_stat(self, path: str) -> Tuple[int, Optional[str]]:
        """(size, ETag) from one HEAD; the ETag pins fan-out reads."""
        resp = self._request("HEAD", self._target(self._key(path)))
        if resp.status != 200:
            raise self._refused(f"HEAD {path}", resp)
        return int(resp.headers.get("Content-Length", -1)), resp.headers.get("ETag") or None

    async def read(self, read_io: ReadIO) -> None:
        from ._ranged import orchestrated_read

        def _single_read() -> memoryview:
            if read_io.byte_range is None:
                return self._stream_get_into(read_io.path, None, None, None)
            start, end = read_io.byte_range
            view = memoryview(np.empty(end - start, dtype=np.uint8))
            return self._stream_get_into(read_io.path, start, end, view)

        def _get():
            begin = time.monotonic()
            ranges = []  # version-pinned range GETs: the fan-out's

            def _stream(s, e, v, version=None, cancel=None):
                if version is not None:
                    ranges.append(e - s)
                return self._stream_get_into(read_io.path, s, e, v, version=version, cancel=cancel)

            out = orchestrated_read(
                byte_range=read_io.byte_range,
                into=read_io.into,
                chunk_executor=self._chunk_executor,
                stream_into=_stream,
                probe_stat=lambda: self._object_stat(read_io.path),
                single_read=_single_read,
                label=f"S3 object {read_io.path}",
            )
            if ranges:
                phase_stats.add("s3_fanout", time.monotonic() - begin, sum(ranges))
            return out

        read_io.buf = await asyncio.get_running_loop().run_in_executor(self._executor, _get)

    # ------------------------------------------------------------- metadata

    async def delete(self, path: str) -> None:
        def _delete() -> None:
            resp = self._request("DELETE", self._target(self._key(path)))
            if resp.status not in (200, 204, 404):
                raise self._refused(f"DELETE {path}", resp)

        await asyncio.get_running_loop().run_in_executor(self._executor, _delete)

    async def exists(self, path: str) -> bool:
        def _head() -> bool:
            resp = self._request("HEAD", self._target(self._key(path)))
            if resp.status == 200:
                return True
            if resp.status == 404:
                return False
            raise self._refused(f"HEAD {path}", resp)

        return await asyncio.get_running_loop().run_in_executor(self._executor, _head)

    def _list(self, prefix: str, delimiter: bool):
        """Pages of (keys, common prefixes) under ``prefix`` (ListObjectsV2)."""
        token: Optional[str] = None
        while True:
            query = "list-type=2" + ("&delimiter=%2F" if delimiter else "")
            query += "&prefix=" + urllib.parse.quote(prefix, safe="")
            if token:
                query += "&continuation-token=" + urllib.parse.quote(token, safe="")
            resp = self._request("GET", f"{self._base_path}?{query}")
            if resp.status != 200:
                raise self._refused("LIST", resp)
            tree = ElementTree.fromstring(resp.content)
            keys = [c.find(f"{_NS}Key").text for c in tree.iter(f"{_NS}Contents")]
            prefixes = [cp.find(f"{_NS}Prefix").text for cp in tree.iter(f"{_NS}CommonPrefixes")]
            yield keys, prefixes
            truncated = tree.find(f"{_NS}IsTruncated")
            if truncated is None or truncated.text != "true":
                return
            token_el = tree.find(f"{_NS}NextContinuationToken")
            token = token_el.text if token_el is not None else None
            if token is None:
                return

    async def list_dir(self, path: str) -> List[str]:
        def _list_dir() -> List[str]:
            prefix = self._key(path).rstrip("/")
            prefix = f"{prefix}/" if prefix else ""
            children = set()
            for keys, prefixes in self._list(prefix, delimiter=True):
                children.update(k[len(prefix) :] for k in keys)
                children.update(p[len(prefix) :].rstrip("/") for p in prefixes)
            return sorted(c for c in children if c)

        return await asyncio.get_running_loop().run_in_executor(self._executor, _list_dir)

    async def delete_dir(self, path: str) -> None:
        def _delete_one(key: str) -> None:
            resp = self._request("DELETE", self._target(key))
            if resp.status not in (200, 204, 404):
                raise self._refused(f"DELETE {key}", resp)

        def _delete_dir() -> None:
            # The per-key DELETEs fan out on their own pool: this function
            # holds an io thread and blocks on them.
            prefix = self._key(path).rstrip("/") + "/"
            for keys, _ in self._list(prefix, delimiter=False):
                for fut in [self._delete_executor.submit(_delete_one, k) for k in keys]:
                    fut.result()

        await asyncio.get_running_loop().run_in_executor(self._executor, _delete_dir)

    # ------------------------------------------------------ server-side copy

    async def copy_from_sibling(self, src_root: str, path: str) -> bool:
        src_bucket, _, src_prefix = src_root.partition("/")
        if src_bucket != self.bucket:
            return False  # copies are same-bucket only: write normally

        def _copy() -> bool:
            src_key = f"{src_prefix.strip('/')}/{path}" if src_prefix.strip("/") else path
            head = self._request("HEAD", self._target(src_key))
            if head.status != 200:
                return False
            src_bytes = int(head.headers.get("Content-Length", 0))
            begin = time.monotonic()
            if src_bytes > self._COPY_MAX_BYTES:
                copied = self._multipart_copy(src_key, path, src_bytes)
            else:
                headers = {"x-amz-copy-source": urllib.parse.quote(f"/{self.bucket}/{src_key}", safe="/")}
                resp = self._request("PUT", self._target(self._key(path)), headers=headers)
                # CopyObject may answer 200 with an <Error> body: success
                # must carry the result, or the manifest would reference an
                # object that does not exist.
                copied = resp.status == 200 and b"CopyObjectResult" in resp.content
            if copied:
                phase_stats.add("s3_copy", time.monotonic() - begin, src_bytes)
            return copied

        return await asyncio.get_running_loop().run_in_executor(self._executor, _copy)

    def _multipart_copy(self, src_key: str, path: str, src_bytes: int) -> bool:
        """Server-side copy of an object over 5 GiB through UploadPartCopy;
        False (after aborting the upload) on any failure."""
        dst_key = self._key(path)
        try:
            upload_id = self._initiate_multipart(dst_key)
        except RuntimeError:
            return False
        try:
            etags = []
            for number, offset in enumerate(range(0, src_bytes, self._COPY_PART_BYTES), start=1):
                end = min(offset + self._COPY_PART_BYTES, src_bytes) - 1
                resp = self._request(
                    "PUT",
                    self._target(dst_key, f"partNumber={number}&uploadId={upload_id}"),
                    headers={
                        "x-amz-copy-source": urllib.parse.quote(f"/{self.bucket}/{src_key}", safe="/"),
                        "x-amz-copy-source-range": f"bytes={offset}-{end}",  # inclusive
                    },
                )
                if resp.status != 200 or b"CopyPartResult" not in resp.content:
                    raise RuntimeError(f"UploadPartCopy {number} failed: {resp.status}")
                tree = ElementTree.fromstring(resp.content)
                etag_el = tree.find(f"{_NS}ETag")
                if etag_el is None:
                    etag_el = tree.find("ETag")
                etags.append((number, etag_el.text if etag_el is not None else ""))
            self._complete_multipart(dst_key, upload_id, etags)
            return True
        except Exception:  # noqa: BLE001 — the caller writes normally
            self._abort_multipart(dst_key, upload_id)
            return False

    # ---------------------------------------------------------------- close

    async def close(self) -> None:
        """Wait for every worker to finish, then close every connection, so
        no thread the plugin started and no socket it opened outlives it."""
        for executor in (self._executor, self._chunk_executor, self._delete_executor):
            executor.shutdown(wait=True)
        with self._conns_lock:
            conns, self._conns = self._conns, []
        for conn in conns:
            conn.close()

