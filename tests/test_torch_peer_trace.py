"""Serving-plane tracing in the port, mirroring the JAX package's
test_peer_trace.py: each injected peer fault leaves a ``peer_fetch`` span
with its outcome (the reject's event carries the trace id), a peer-first
restore against two port daemons stitches one trace id across the
client's ``peer_fetch`` spans and the daemons' ``peerd_handle`` spans,
the daemon's ``/metrics`` serves the fetch histogram, and the daemon's
span buffer and access log stay bounded.  Spans are compared by name,
status, parent and bytes; the one duration checked is an injected
delay's lower bound."""

import glob
import json
import os
import urllib.request

import pytest

import torchsnapshot_tpu_torch as ts
from torchsnapshot_tpu_torch import knobs
from torchsnapshot_tpu_torch import peer as peer_mod
from torchsnapshot_tpu_torch.event_handlers import register_event_handler, unregister_event_handler
from torchsnapshot_tpu_torch.telemetry import metrics
from torchsnapshot_tpu_torch.telemetry import trace as ttrace

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures
from torch_peer_env import arrays, assert_equal, daemon, peer_env, state, warm_into, zeros  # noqa: F401


@pytest.fixture(autouse=True)
def clean_metrics():
    metrics.uninstall_event_bridge()
    metrics.reset()
    yield
    metrics.uninstall_event_bridge()
    metrics.reset()


def _take(tmp_path, arrs):
    snap_path = str(tmp_path / "root" / "step_1")
    with knobs.override_cas(True):
        snap = ts.Snapshot.take(snap_path, state(arrs))
    return snap, snap_path


def _trace_docs(trace_dir):
    docs = []
    for path in sorted(glob.glob(os.path.join(trace_dir, f"*{ttrace.TRACE_FILE_SUFFIX}"))):
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        doc["_file"] = os.path.basename(path)
        docs.append(doc)
    return docs


def _spans(docs, name):
    return [ev for doc in docs for ev in doc.get("traceEvents", []) if ev.get("ph") == "X" and ev.get("name") == name]


@pytest.mark.parametrize(
    "spec,expect_status",
    [
        ("peer:1:peer_unreachable", "error"),
        ("peer:1:peer_slow:0.2", "hit"),
        ("peer:1:peer_truncated", "reject"),
    ],
)
def test_fault_injected_fetch_spans(peer_env, spec, expect_status):
    tmp_path = peer_env
    snap, snap_path = _take(tmp_path, arrays(leaves=1))
    warm_into(snap_path, snap.metadata, str(tmp_path / "cacheA"))
    trace_dir = str(tmp_path / "traces")
    events = []
    register_event_handler(events.append)
    try:
        with daemon(str(tmp_path / "cacheA")) as d:
            inv = json.loads(urllib.request.urlopen(f"http://{d.addr}/inventory").read())
            _, algo, hexdigest = inv["chunks"][0]["key"].split("/")
            kv = peer_mod.resolve_kv_store()
            with knobs.override_trace_dir(trace_dir), knobs.override_faults(spec), knobs.override_peer_timeout_s(
                2.0
            ), knobs.override_peer_retries(0):
                op = ttrace.begin_op("restore", "faultop1", 0)
                try:
                    data = peer_mod.PeerClient(kv).fetch_chunk(algo, hexdigest)
                finally:
                    ttrace.end_op(op)
    finally:
        unregister_event_handler(events.append)
    span = _spans(_trace_docs(trace_dir), "peer_fetch")[0]
    assert span["args"]["status"] == expect_status
    assert span["args"]["peer"] == d.addr and span["args"]["digest"] == f"{algo}:{hexdigest}"
    if expect_status == "hit":
        assert data is not None and span["args"]["bytes"] == len(data)
        assert span["dur"] >= 0.18e6, span["dur"]  # the injected 0.2 s delay
        assert span["args"]["ttfb_s"] > 0 and span["args"]["transfer_s"] >= 0
    else:
        assert data is None and span["args"]["bytes"] == 0
    if expect_status == "reject":
        rejects = [e for e in events if e.name == "peer.reject"]
        assert rejects and rejects[0].metadata.get("trace") == ttrace.trace_id_for("faultop1")


def test_two_daemon_restore_stitches_one_trace(peer_env):
    """A peer-first restore against two port daemons yields one trace id
    across the client's ``peer_fetch`` spans and the daemons'
    ``peerd_handle`` spans (whose remote parents are the client spans that
    issued them); ``merge_fleet_traces`` stitches the files into one valid
    timeline; the access logs are schema-valid."""
    tmp_path = peer_env
    arrs = arrays()
    snap, snap_path = _take(tmp_path, arrs)
    warm_into(snap_path, snap.metadata, str(tmp_path / "cacheA"))
    warm_into(snap_path, snap.metadata, str(tmp_path / "cacheB"))
    trace_dir = str(tmp_path / "traces")
    with knobs.override_trace_dir(trace_dir):
        with daemon(str(tmp_path / "cacheA")), daemon(str(tmp_path / "cacheB")):
            with knobs.override_cache_dir(str(tmp_path / "cacheC")), knobs.override_peer_fetch(True):
                dst = zeros(arrs)
                snap.restore(dst)
    assert_equal(dst, arrs)
    assert peer_mod.process_stats()["hit_bytes"] > 0

    docs = _trace_docs(trace_dir)
    restore_docs = [d for d in docs if d["otherData"].get("kind") == "restore"]
    trace_id = restore_docs[0]["otherData"]["trace_id"]
    client_fetches = _spans(restore_docs, "peer_fetch")
    assert client_fetches and all(ev["args"]["status"] in ("hit", "miss") for ev in client_fetches)
    peerd_docs = [d for d in docs if d["otherData"].get("kind") == "peerd"]
    assert len(peerd_docs) == 2, [d["_file"] for d in docs]
    stitched = [ev for ev in _spans(peerd_docs, "peerd_handle") if ev["args"].get("trace") == trace_id]
    fetch_span_ids = {f"{ev['args']['span_id']:016x}" for ev in client_fetches}
    assert stitched and all(ev["args"]["parent"] in fetch_span_ids for ev in stitched)
    assert all(ev["args"]["status"] in (200, 206, 404) and "digest" in ev["args"] for ev in stitched)
    served = sum(ev["args"]["bytes"] for ev in stitched if ev["args"]["status"] == 200)
    assert served == sum(ev["args"]["bytes"] for ev in client_fetches if ev["args"]["status"] == "hit")

    paths = sorted(glob.glob(os.path.join(trace_dir, f"*{ttrace.TRACE_FILE_SUFFIX}")))
    merged = ttrace.merge_fleet_traces(paths)
    assert ttrace.validate_trace(merged) == []
    assert trace_id in merged["otherData"]["trace_ids"]
    assert len({src["file"] for src in merged["otherData"]["merged_from"]}) >= 3  # the client and two daemons
    logs = glob.glob(os.path.join(trace_dir, f"*{ttrace.ACCESS_LOG_SUFFIX}"))
    assert logs
    lines = []
    for log_path in logs:
        assert ttrace.validate_access_log(log_path) == []
        with open(log_path, encoding="utf-8") as f:
            lines += [json.loads(ln) for ln in f if ln.strip()]
    traced = [ln for ln in lines if ln.get("trace") == trace_id]
    assert len(traced) == len(stitched) and all(ln["status"] in (200, 206, 404) for ln in traced)


def test_daemon_metrics_endpoint_exposes_fetch_histogram(peer_env):
    """GET /metrics serves the process registry: the daemon's request
    counter and, after an in-process peer-first restore, the peer-fetch
    histogram with its sub-10 ms buckets."""
    tmp_path = peer_env
    arrs = arrays(leaves=1)
    snap, snap_path = _take(tmp_path, arrs)
    warm_into(snap_path, snap.metadata, str(tmp_path / "cacheA"))
    with knobs.override_metrics(True):
        with daemon(str(tmp_path / "cacheA")) as d:
            with knobs.override_cache_dir(str(tmp_path / "cacheB")), knobs.override_peer_fetch(True):
                snap.restore(zeros(arrs))
            resp = urllib.request.urlopen(f"http://{d.addr}/metrics")
            assert resp.status == 200
            assert resp.headers["Content-Type"].startswith("text/plain")
            body = resp.read().decode("utf-8")
        hits = metrics.counter("tpusnap_peer_hits_total").get()
    assert hits >= 1
    assert f'tpusnap_peerd_requests_total{{kind="chunk",status="200"}} {int(hits)}' in body
    assert "tpusnap_peer_fetch_seconds_bucket" in body and 'le="0.001"' in body


def test_server_tracer_caps_spans_and_access_log_rotates(tmp_path):
    """The daemon's span buffer keeps the newest ``TPUSNAP_PEER_TRACE_MAX_SPANS``
    and counts the dropped ones in the file; the access log rotates to
    ``<path>.1`` past its byte bound, every line still schema-valid."""
    with knobs.override_peer_trace_max_spans(3), knobs.override_peer_trace_flush_s(60.0):
        tracer = ttrace.ServerTracer(str(tmp_path / "tr"), "a" * 32)
        try:
            for i in range(5):
                tracer.record_span("peerd_handle", float(i), 1.0, {"status": 200, "bytes": i})
        finally:
            path = tracer.close()
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    assert ttrace.validate_trace(doc) == [] and doc["otherData"]["dropped_spans"] == 2
    assert [e["args"]["bytes"] for e in doc["traceEvents"] if e["ph"] == "X"] == [2, 3, 4]

    log_path = str(tmp_path / "access.jsonl")
    with knobs.override_peerd_access_log_max_bytes(4096):
        log = ttrace.AccessLog(log_path)
    line = dict(ts=1.0, trace=None, digest="xxh64:" + "0" * 16, range=None, status=200, bytes=1, wall_s=0.1,
                client="127.0.0.1")
    n = 4096 // len(json.dumps(line)) + 5
    for _ in range(n):
        log.log(**line)
    assert os.path.exists(log_path + ".1")
    assert ttrace.validate_access_log(log_path) == ttrace.validate_access_log(log_path + ".1") == []
    with open(log_path) as a, open(log_path + ".1") as b:
        assert len(a.readlines()) + len(b.readlines()) == n
