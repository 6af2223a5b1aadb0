"""The port's native build publishes its library as the JAX build does:
the compiled temporary file is fsync'd before it is renamed over the
library, so a host crash mid-build leaves the old library or the new one,
never a truncated one that later processes would load.  The compiler is
stubbed and everything lands under the test's temporary directory:
nothing is compiled into ``_native/_build/``."""

import os
import subprocess

import pytest

from torchsnapshot_tpu_torch._native import build

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")


@pytest.mark.parametrize("flags", [(), tuple(build._SANITIZE_FLAGS["asan"])], ids=["production", "sanitizer"])
def test_build_fsyncs_the_library_before_the_rename(tmp_path, monkeypatch, flags):
    out = str(tmp_path / "libtpusnap_torch.so")
    calls = []

    def fake_compiler(cmd, **kwargs):
        tmp = cmd[cmd.index("-o") + 1]
        with open(tmp, "wb") as f:
            f.write(b"\x7fELF library bytes")
        calls.append(("compile", tmp, tuple(flags) == tuple(cmd[len(build._CMD) : len(build._CMD) + len(flags)])))
        return subprocess.CompletedProcess(cmd, 0, "", "")

    real_fsync, real_replace = os.fsync, os.replace

    def fsync(fd):
        calls.append(("fsync", os.readlink(f"/proc/self/fd/{fd}")))
        real_fsync(fd)

    def replace(src, dst):
        calls.append(("replace", src, dst))
        real_replace(src, dst)

    monkeypatch.setattr(build, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build.subprocess, "run", fake_compiler)
    monkeypatch.setattr(build.os, "fsync", fsync)
    monkeypatch.setattr(build.os, "replace", replace)
    build._build(out, flags)

    (compiled,) = [c for c in calls if c[0] == "compile"]
    tmp = compiled[1]
    assert compiled[2], "the sanitizer flags did not reach the compiler"
    assert tmp != out and os.path.dirname(tmp) == str(tmp_path)
    assert [c[0] for c in calls] == ["compile", "fsync", "replace"]
    assert calls[1] == ("fsync", tmp)
    assert calls[2] == ("replace", tmp, out)
    with open(out, "rb") as f:
        assert f.read() == b"\x7fELF library bytes"
    assert not os.path.exists(tmp)
