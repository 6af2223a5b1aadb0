"""Telemetry across the two packages: torchsnapshot_tpu and
torchsnapshot_tpu_torch trace and count the same work alike.

The same seeded state (numpy arrays, then each package's array type),
taken and restored by each package under its own trace directory, gives
the same multiset of span names with their byte args; each package's
``validate_trace`` accepts the other's files and either package's
``merge_trace_files`` merges them; ``trace_id_for`` agrees; the two
``render_prometheus()`` outputs hold the same families, types and label
sets and equal byte and entry counters.  A port client restoring through
a JAX daemon, and a JAX client through a port daemon, stitch one trace id
with the daemon's span parented on the client's ``peer_fetch``.  The
sharded-elasticity root-only knob leaves a manifest the same in both
packages, on and off.  Durations and histogram sums are never compared."""

import collections
import glob
import json
import os
import warnings

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jax_pkg
import torchsnapshot_tpu_torch as port_pkg
from torchsnapshot_tpu import cache as jax_cache
from torchsnapshot_tpu import knobs as jax_knobs
from torchsnapshot_tpu import manifest as jax_manifest
from torchsnapshot_tpu import manifest_ops as jax_manifest_ops
from torchsnapshot_tpu import peer as jax_peer
from torchsnapshot_tpu import peerd as jax_peerd
from torchsnapshot_tpu.telemetry import metrics as jax_metrics
from torchsnapshot_tpu.telemetry import trace as jax_trace
from torchsnapshot_tpu_torch import cache as port_cache
from torchsnapshot_tpu_torch import knobs
from torchsnapshot_tpu_torch import manifest as port_manifest
from torchsnapshot_tpu_torch import manifest_ops as port_manifest_ops
from torchsnapshot_tpu_torch import peer as port_peer
from torchsnapshot_tpu_torch import peerd as port_peerd
from torchsnapshot_tpu_torch.serialization import state_from_numpy
from torchsnapshot_tpu_torch.telemetry import metrics as port_metrics
from torchsnapshot_tpu_torch.telemetry import trace as port_trace

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures
from torch_peer_env import arrays, daemon, peer_env, warm_into  # noqa: F401  peer_env is a fixture

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

PKGS = {"jax": (jax_pkg, jax_trace, jax_metrics), "port": (port_pkg, port_trace, port_metrics)}
# Gauges of the JAX package's progress reporter, which the port does not
# have yet; every other family is held equal.
JAX_ONLY_FAMILIES = {
    "tpusnap_progress_requests_total",
    "tpusnap_progress_requests_staged",
    "tpusnap_progress_requests_written",
    "tpusnap_progress_bytes_staged",
    "tpusnap_progress_bytes_written",
}


@pytest.fixture(autouse=True)
def clean_registries():
    for m in (jax_metrics, port_metrics):
        m.uninstall_event_bridge()
        m.reset()
    yield
    for m in (jax_metrics, port_metrics):
        m.uninstall_event_bridge()
        m.reset()


def _arrays():
    rng = np.random.default_rng(16)
    return {
        "w": rng.standard_normal((512, 256)).astype(np.float32),
        "emb": rng.standard_normal((1024, 64)).astype(np.float32),
        "b": rng.standard_normal(512).astype(np.float32),
        "norm": np.ones(256, np.float32),
        "step": 7,
    }


def _app_state(pkg, arrs):
    if pkg == "port":
        return {"m": port_pkg.StateDict(state_from_numpy(dict(arrs)))}
    return {"m": jax_pkg.StateDict(dict(arrs))}


def _take_restore(pkg, tmp_path):
    """One take and one in-place restore by ``pkg``, traced into its own
    directory, sidecars off (their JSON differs in a few bytes); returns
    the trace directory."""
    trace_dir = str(tmp_path / f"{pkg}_traces")
    with knobs.override_trace_dir(trace_dir), knobs.override_sidecar(False):
        PKGS[pkg][0].Snapshot.take(str(tmp_path / pkg), _app_state(pkg, _arrays()))
        zeros = {k: (np.zeros_like(v) if isinstance(v, np.ndarray) else 0) for k, v in _arrays().items()}
        dst = _app_state(pkg, zeros)
        PKGS[pkg][0].Snapshot(str(tmp_path / pkg)).restore(dst)
    for k, v in _arrays().items():
        got = dst["m"][k]
        assert np.array_equal(got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got), v), k
    return trace_dir


def _trace_files(trace_dir):
    return sorted(glob.glob(os.path.join(trace_dir, "*" + port_trace.TRACE_FILE_SUFFIX)))


def _span_multiset(trace_dir):
    out = collections.Counter()
    for path in _trace_files(trace_dir):
        kind = os.path.basename(path).split("-")[0]
        with open(path, encoding="utf-8") as f:
            for ev in json.load(f)["traceEvents"]:
                if ev["ph"] == "X":
                    out[(kind, ev["name"], ev.get("cat"), ev["args"].get("bytes"))] += 1
    return out


def test_span_names_and_bytes_match_across_packages(tmp_path):
    jax_spans = _span_multiset(_take_restore("jax", tmp_path))
    port_spans = _span_multiset(_take_restore("port", tmp_path))
    assert port_spans == jax_spans
    names = {name for _, name, _, _ in port_spans}
    assert {"take", "restore", "flatten", "plan", "write_staging", "io_drain", "read_pipeline", "plan_read",
            "load_stateful", "h2d_drain", "native_write_hash", "checksum"} <= names


def test_each_package_validates_and_merges_the_others_files(tmp_path):
    files = {pkg: _trace_files(_take_restore(pkg, tmp_path)) for pkg in PKGS}
    for reader in PKGS:
        r_trace = PKGS[reader][1]
        for writer in PKGS:
            for path in files[writer]:
                with open(path, encoding="utf-8") as f:
                    assert r_trace.validate_trace(json.load(f)) == [], (reader, path)
        merged = r_trace.merge_trace_files(files["jax"] + files["port"])
        assert r_trace.validate_trace(merged) == []
        assert sorted(s["kind"] for s in merged["otherData"]["merged_from"]) == ["restore", "restore", "take", "take"]
        fleet = r_trace.merge_fleet_traces(files["jax"] + files["port"])
        assert len(fleet["otherData"]["trace_ids"]) == 4


def test_trace_id_for_and_traceparent_agree():
    for op_id in ("op-123", "0" * 32, "a1b2c3d4e5f6", "ünïcode"):
        assert port_trace.trace_id_for(op_id) == jax_trace.trace_id_for(op_id)
    header = f"00-{jax_trace.trace_id_for('x')}-00000000000000ab-01"
    assert port_trace.parse_traceparent(header) == jax_trace.parse_traceparent(header)
    for bad in (None, "", "junk", "00-short-ab-01", f"00-{'0' * 32}-{'1' * 16}-01"):
        assert port_trace.parse_traceparent(bad) == jax_trace.parse_traceparent(bad) is None


def _families(text):
    """{family: (type, {label-name sets})} and {sample line without value: value}."""
    fams, samples = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, mtype = line.split(" ")
            fams[name] = (mtype, set())
        elif line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            name, _, labels = key.partition("{")
            base = next(f for f in (name, name.rsplit("_", 1)[0]) if f in fams)
            fams[base][1].add(tuple(sorted(kv.split("=", 1)[0] for kv in labels.rstrip("}").split(",") if kv)))
            samples[key] = float(value)
    return fams, samples


def test_prometheus_families_types_labels_and_counters_match(tmp_path):
    texts = {}
    for pkg in PKGS:
        with knobs.override_metrics(True):
            _take_restore(pkg, tmp_path)
        texts[pkg] = PKGS[pkg][2].render_prometheus()
    jax_fams, jax_samples = _families(texts["jax"])
    port_fams, port_samples = _families(texts["port"])
    assert set(jax_fams) - set(port_fams) == JAX_ONLY_FAMILIES
    assert set(port_fams) - set(jax_fams) == set()
    for name, spec in port_fams.items():
        assert spec == jax_fams[name], name
    for key in ("tpusnap_storage_bytes_written_total", "tpusnap_storage_bytes_read_total",
                'tpusnap_operation_bytes_total{action="take"}', 'tpusnap_operation_bytes_total{action="restore"}',
                'tpusnap_manifest_entries_total{action="take"}', 'tpusnap_manifest_entries_total{action="restore"}',
                'tpusnap_operations_total{action="take",outcome="success"}',
                'tpusnap_open_operations{action="restore"}'):
        assert port_samples[key] == jax_samples[key], key
    assert port_samples["tpusnap_storage_bytes_written_total"] > 0


@pytest.mark.parametrize("client,server", [("port", "jax"), ("jax", "port")])
def test_peer_fetch_stitches_with_the_other_packages_daemon(peer_env, client, server):
    """A traced peer-first restore by ``client`` through a daemon of
    ``server``: the daemon's ``peerd_handle`` spans carry the client's
    trace id and name its ``peer_fetch`` spans as parents, and its access
    log validates under both packages' validators."""
    tmp_path = peer_env
    arrs = arrays(leaves=2)
    path = str(tmp_path / "root" / "step_1")
    c_pkg = PKGS[client][0]
    s_peerd, s_cache = {"jax": (jax_peerd, jax_cache), "port": (port_peerd, port_cache)}[server]
    with knobs.override_cas(True):
        c_pkg.Snapshot.take(path, _app_state(client, arrs))
    md = PKGS[server][0].Snapshot(path).metadata
    warm_into(path, md, str(tmp_path / "cacheA"), peerd=s_peerd, cache=s_cache)
    trace_dir = str(tmp_path / "traces")
    jax_peer.reset_process_stats()
    with knobs.override_trace_dir(trace_dir), daemon(str(tmp_path / "cacheA"), peerd=s_peerd):
        with knobs.override_cache_dir(str(tmp_path / "cacheB")), knobs.override_peer_fetch(True):
            zeros = {k: np.zeros_like(v) for k, v in arrs.items()}
            c_pkg.Snapshot(path).restore(_app_state(client, zeros))
    stats = {"jax": jax_peer, "port": port_peer}[client].process_stats()
    assert stats["hit_bytes"] > 0 and stats["misses"] == 0, stats

    docs = []
    for p in _trace_files(trace_dir):
        with open(p, encoding="utf-8") as f:
            docs.append(json.load(f))
    restore = next(d for d in docs if d["otherData"]["kind"] == "restore")
    trace_id = restore["otherData"]["trace_id"]
    fetch_ids = {f"{e['args']['span_id']:016x}" for e in restore["traceEvents"] if e.get("name") == "peer_fetch"}
    handles = [e for d in docs if d["otherData"]["kind"] == "peerd" for e in d["traceEvents"]
               if e.get("name") == "peerd_handle" and e["args"].get("trace") == trace_id]
    assert fetch_ids and handles and all(e["args"]["parent"] in fetch_ids for e in handles)
    for r_trace in (jax_trace, port_trace):
        merged = r_trace.merge_fleet_traces(_trace_files(trace_dir))
        assert r_trace.validate_trace(merged) == [] and trace_id in merged["otherData"]["trace_ids"]
        for log in glob.glob(os.path.join(trace_dir, "*" + port_trace.ACCESS_LOG_SUFFIX)):
            assert r_trace.validate_access_log(log) == []


def _elasticity_case(mod, manifest_mod, root_level):
    """``handle_sharded_array_elasticity`` of one package on a manifest
    ``{"model": DictEntry}`` and a sharded request at the root
    (``model/w``) or nested (``model/layer/w``); returns the manifest's
    keys and the DictEntry's keys."""
    path = "model/w" if root_level else "model/layer/w"
    manifest = {"model": manifest_mod.DictEntry(keys=[])}
    merged = {path: manifest_mod.ShardedArrayEntry(dtype="float32", shape=[8], shards=[])}
    mod.handle_sharded_array_elasticity(manifest, merged, [path])
    return sorted(manifest), list(manifest["model"].keys)


@pytest.mark.parametrize("root_only", [False, True])
def test_sharded_elasticity_root_only_knob_as_in_the_jax_package(root_only):
    with knobs.override_sharded_elasticity_root_only(root_only):
        assert port_pkg.knobs.is_sharded_elasticity_root_only_enabled() == root_only
        for root_level in (True, False):
            jax_out = _elasticity_case(jax_manifest_ops, jax_manifest, root_level)
            port_out = _elasticity_case(port_manifest_ops, port_manifest, root_level)
            assert port_out == jax_out, (root_level, port_out, jax_out)
        # Nested with the knob on: the manifest is left as it was.
        assert (_elasticity_case(port_manifest_ops, port_manifest, False)[0] == ["model"]) == root_only


TELEMETRY_KNOBS = {
    "TPUSNAP_TRACE_DIR": (" /tmp/tr ", "get_trace_dir"),
    "TPUSNAP_METRICS": ("1", "metrics_enabled"),
    "TPUSNAP_PEER_TRACE_MAX_SPANS": ("7", "get_peer_trace_max_spans"),
    "TPUSNAP_PEER_TRACE_FLUSH_S": ("0.01", "get_peer_trace_flush_s"),
    "TPUSNAP_PEERD_ACCESS_LOG": (" /tmp/a.jsonl ", "get_peerd_access_log"),
    "TPUSNAP_PEERD_ACCESS_LOG_MAX_BYTES": ("100", "get_peerd_access_log_max_bytes"),
    "TPUSNAP_ENABLE_SHARDED_ARRAY_ELASTICITY_ROOT_ONLY": ("1", "is_sharded_elasticity_root_only_enabled"),
}


def test_telemetry_knobs_read_as_in_the_jax_package_and_do_not_warn():
    for name, (value, getter) in TELEMETRY_KNOBS.items():
        assert getattr(port_pkg.knobs, getter)() == getattr(jax_knobs, getter)(), name
        with knobs.override_env(name, value):
            assert getattr(port_pkg.knobs, getter)() == getattr(jax_knobs, getter)(), name
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                knobs.warn_unimplemented_knobs()
