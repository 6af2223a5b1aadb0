"""Fixtures that the port's test files import.

``default_knob_env`` (autouse): every test starts from the default knob
environment.  Both packages read their knobs from the same ``TPUSNAP_*``
variables, and a test of torchsnapshot_tpu whose threads override one
concurrently (its manager pins ``TPUSNAP_STORE`` and ``TPUSNAP_CAS`` for
each take) can leave it set in the process for whichever test file runs
next.  The variables a multi-process test hands its ranks
(``TPUSNAP_TEST_*``) are kept.  After the test, the port's process-global
direct-I/O mode is put back to off, when the native library is loaded (the
fixture never loads or builds it).

``no_leaked_threads``: the test leaves no Python thread it started alive,
so that nothing it started runs on in the worker process under the tests
that follow.  The native library's worker pool is C++ threads that live
for the process by design; ``threading.enumerate()`` does not list them."""

import os
import threading

import pytest


@pytest.fixture(autouse=True)
def default_knob_env(monkeypatch):
    for name in [k for k in os.environ if k.startswith("TPUSNAP_") and not k.startswith("TPUSNAP_TEST_")]:
        monkeypatch.delenv(name)
    yield
    from torchsnapshot_tpu_torch.native_io import NativeFileIO

    native = NativeFileIO._instance
    if native is not None and native.direct_io_mode() != 0:
        native.configure_direct_io(False)


@pytest.fixture
def no_leaked_threads():
    before = set(threading.enumerate())
    yield
    leaked = [t.name for t in threading.enumerate() if t not in before]
    assert leaked == [], f"threads left alive: {leaked}"
