"""Autouse fixture that the port's test files import: every test starts
from the default knob environment.

Both packages read their knobs from the same ``TPUSNAP_*`` variables, and
a test of torchsnapshot_tpu whose threads override one concurrently (its
manager pins ``TPUSNAP_STORE`` and ``TPUSNAP_CAS`` for each take) can leave
it set in the process for whichever test file runs next.  The variables a
multi-process test hands its ranks (``TPUSNAP_TEST_*``) are kept."""

import os

import pytest


@pytest.fixture(autouse=True)
def default_knob_env(monkeypatch):
    for name in [k for k in os.environ if k.startswith("TPUSNAP_") and not k.startswith("TPUSNAP_TEST_")]:
        monkeypatch.delenv(name)
    yield
