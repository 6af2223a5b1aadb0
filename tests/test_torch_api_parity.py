"""The port's public surface held against the JAX package's: positional
parameters of the public ``Snapshot``, ``PendingSnapshot`` and
``SnapshotManager`` methods (so a positional call means the same in both),
the package exports, and the knob names (every ``TPUSNAP_*`` knob of the
JAX package is read by the port, warns that it is not implemented yet, or
has no meaning in torch: none is ignored without a word)."""

import inspect

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jax_pkg
from torchsnapshot_tpu import knobs as jax_knobs

import torchsnapshot_tpu_torch as port_pkg
from torchsnapshot_tpu_torch import knobs as port_knobs

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

# Exported by the JAX package and owed by a later slice of the port.
NOT_PORTED_EXPORTS = set()


def _positional(fn):
    return [
        p.name
        for p in inspect.signature(fn).parameters.values()
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
    ]


def test_public_positional_parameters_match_the_jax_package():
    """Each public method of the three classes exists in both packages, and
    the port's positional parameters start with the JAX package's, in the
    same order (the port's own, such as ``device``, come after).  One case
    loops over every method.  ``PendingSnapshot`` is built by
    ``async_take`` only, so its constructor is not compared."""
    compared = []
    for cls_name in ("Snapshot", "PendingSnapshot", "SnapshotManager"):
        jax_cls, port_cls = getattr(jax_pkg, cls_name), getattr(port_pkg, cls_name)
        names = {n for n in dir(jax_cls) if not n.startswith("_") and callable(getattr(jax_cls, n))}
        if cls_name != "PendingSnapshot":
            names.add("__init__")
        for name in sorted(names):
            assert hasattr(port_cls, name), f"{cls_name}.{name} is missing from the port"
            jax_params = _positional(getattr(jax_cls, name))
            port_params = _positional(getattr(port_cls, name))
            assert port_params[: len(jax_params)] == jax_params, (cls_name, name, jax_params, port_params)
            compared.append(f"{cls_name}.{name}")
    assert {"Snapshot.take", "Snapshot.async_take", "Snapshot.read_object", "Snapshot.get_state_dict_for_key",
            "SnapshotManager.save", "PendingSnapshot.wait"} <= set(compared)


def test_package_exports_match_the_jax_package():
    assert set(jax_pkg.__all__) - set(port_pkg.__all__) == NOT_PORTED_EXPORTS
    assert port_pkg.PendingSnapshot is port_pkg.snapshot.PendingSnapshot
    assert port_pkg.__version__ == jax_pkg.__version__


def test_positional_budget_and_rank0_flag_read_as_in_the_jax_package(tmp_path):
    """``read_object(path, obj_out, memory_budget_bytes)`` and
    ``get_state_dict_for_key(key, replicate_from_rank0)`` positionally, as
    the JAX package takes them, give the JAX package's values; the port's
    ``device`` comes by keyword after them."""
    w = np.random.RandomState(0).rand(1 << 18).astype(np.float32)  # 1 MiB
    path = str(tmp_path / "snap")
    jax_pkg.Snapshot.take(path, {"m": jax_pkg.StateDict({"w": w, "step": 7})})
    jax_snap, port_snap = jax_pkg.Snapshot(path), port_pkg.Snapshot(path)
    want = np.asarray(jax_snap.read_object("0/m/w", None, 1 << 16))
    got = port_snap.read_object("0/m/w", None, 1 << 16, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    into = torch.zeros(1 << 18)
    assert port_snap.read_object("0/m/w", into, 1 << 16) is into
    np.testing.assert_array_equal(into.numpy(), w)
    assert port_snap.read_object("0/m/step", None, 1 << 16) == jax_snap.read_object("0/m/step", None, 1 << 16) == 7
    jax_sd = jax_snap.get_state_dict_for_key("m", True)
    port_sd = port_snap.get_state_dict_for_key("m", True, device="cpu")
    assert port_sd["step"] == jax_sd["step"] == 7
    np.testing.assert_array_equal(port_sd["w"].numpy(), np.asarray(jax_sd["w"]))


def _knob_names(module):
    return {v for k, v in vars(module).items() if k.endswith("_ENV_VAR") and isinstance(v, str)}


def test_every_jax_knob_is_read_unimplemented_or_meaningless_in_the_port():
    """Every ``TPUSNAP_*`` knob the JAX package defines is named by the
    port, and in exactly one way: read by the port, listed in
    ``UNIMPLEMENTED_KNOBS`` (warns once when set), or listed in
    ``MEANINGLESS_IN_TORCH_KNOBS``.  The port names no knob the JAX package
    lacks.  A module that lands takes its knobs out of
    ``UNIMPLEMENTED_KNOBS``; one that drops a knob fails here."""
    jax_names, port_names = _knob_names(jax_knobs), _knob_names(port_knobs)
    unimplemented = set(port_knobs.UNIMPLEMENTED_KNOBS)
    meaningless = set(port_knobs.MEANINGLESS_IN_TORCH_KNOBS)
    assert len(jax_names) == 85 and all(n.startswith("TPUSNAP_") for n in jax_names)
    assert sorted(jax_names - port_names) == []
    assert sorted(port_names - jax_names) == []
    assert unimplemented | meaningless <= port_names and not unimplemented & meaningless
    read = port_names - unimplemented - meaningless
    assert meaningless == {"TPUSNAP_D2H_BITCAST", "TPUSNAP_H2D_BITCAST"}
    assert {"TPUSNAP_GCS_ENDPOINT", "TPUSNAP_S3_ENDPOINT", "TPUSNAP_CAS", "TPUSNAP_CACHE_DIR", "TPUSNAP_CACHE_MAX_BYTES"} <= read
    assert set(PEER_KNOBS) <= read
    assert len(unimplemented) == len(port_knobs.UNIMPLEMENTED_KNOBS) == 1
    # Read since the telemetry slice (tracing, metrics, the daemon's server
    # tracer and access log) and the sharded-elasticity repair.
    assert {
        "TPUSNAP_TRACE_DIR",
        "TPUSNAP_METRICS",
        "TPUSNAP_PEER_TRACE_MAX_SPANS",
        "TPUSNAP_PEER_TRACE_FLUSH_S",
        "TPUSNAP_PEERD_ACCESS_LOG",
        "TPUSNAP_PEERD_ACCESS_LOG_MAX_BYTES",
        "TPUSNAP_ENABLE_SHARDED_ARRAY_ELASTICITY_ROOT_ONLY",
    } <= read
    # Read since the health monitor and flight-recorder slice.
    assert {
        "TPUSNAP_PROGRESS_INTERVAL_S",
        "TPUSNAP_STALL_TIMEOUT_S",
        "TPUSNAP_STALL_ESCALATE",
        "TPUSNAP_HEARTBEAT_FILE",
        "TPUSNAP_BLACKBOX",
        "TPUSNAP_BLACKBOX_SLOTS",
        "TPUSNAP_BLACKBOX_SLOT_BYTES",
    } <= read
    # Read since the sampling profiler's slice.
    assert {"TPUSNAP_PROFILE", "TPUSNAP_PROFILE_HZ"} <= read
    # Read since the fleet-telemetry slice.
    assert {"TPUSNAP_FLEET_TELEMETRY", "TPUSNAP_FLEET_TELEMETRY_INTERVAL_S", "TPUSNAP_FLEET_TELEMETRY_STALE_S"} <= read
    assert unimplemented == {"TPUSNAP_NATIVE"}


# The peer tier's knobs, each with a value to set and its getter's name.
PEER_KNOBS = {
    "TPUSNAP_PEER_FETCH": ("1", "peer_fetch_enabled"),
    "TPUSNAP_PEER_PORT": ("8997", "get_peer_port"),
    "TPUSNAP_PEER_ADDR": (" 10.0.0.7:8997 ", "get_peer_addr"),
    "TPUSNAP_PEER_TIMEOUT_S": ("0.01", "get_peer_timeout_s"),
    "TPUSNAP_PEER_RETRIES": ("3", "get_peer_retries"),
    "TPUSNAP_PEER_GRACE_S": ("1.5", "get_peer_grace_s"),
    "TPUSNAP_PEER_BAD_TTL_S": ("7", "get_peer_bad_ttl_s"),
    "TPUSNAP_PEER_DEMOTE_FACTOR": ("2.5", "get_peer_demote_factor"),
}


def test_peer_knobs_are_read_as_in_the_jax_package_and_do_not_warn():
    """The eight peer knobs left ``UNIMPLEMENTED_KNOBS`` with the peer tier:
    set, none warns, and each getter reads what the JAX package's reads
    (and its default when unset)."""
    import warnings

    for name, (value, getter) in PEER_KNOBS.items():
        assert getattr(port_knobs, getter)() == getattr(jax_knobs, getter)(), name
        with port_knobs.override_env(name, value):
            assert getattr(port_knobs, getter)() == getattr(jax_knobs, getter)(), name
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                port_knobs.warn_unimplemented_knobs()


@pytest.mark.parametrize("value", ["", "  http://127.0.0.1:9/  "])
def test_gcs_endpoint_knob_as_in_the_jax_package(monkeypatch, value):
    monkeypatch.setenv("TPUSNAP_GCS_ENDPOINT", value)
    assert port_knobs.GCS_ENDPOINT_ENV_VAR == jax_knobs.GCS_ENDPOINT_ENV_VAR
    assert port_knobs.get_gcs_endpoint() == jax_knobs.get_gcs_endpoint() == (value.strip() or None)
