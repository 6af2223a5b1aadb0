"""The port's inspection CLI (``python -m torchsnapshot_tpu_torch``): mirrors
of tests/test_cli.py's eight cases, driven in-process through
``main(argv)``, plus ``cat``'s device: a tensor is read onto ``--device``
(``cpu`` here, the default ``cuda`` raises without a GPU), a dtype numpy has
prints through numpy, and ``bfloat16`` prints through torch with the same
threshold and edge items."""

import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, StateDict, knobs
from torchsnapshot_tpu_torch.__main__ import main
from torchsnapshot_tpu_torch.manager import SnapshotManager

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")


def _snap(tmp_path):
    state = {"w": torch.arange(8, dtype=torch.float32), "step": 12}
    Snapshot.take(str(tmp_path / "snap"), {"m": StateDict(state)})
    return str(tmp_path / "snap")


def test_cli_info(tmp_path, capsys):
    path = _snap(tmp_path)
    assert main(["info", path]) == 0
    out = capsys.readouterr().out
    assert "world_size:  1" in out
    assert "entries:" in out
    assert "array bytes: 32.0B" in out


def test_cli_ls(tmp_path, capsys):
    path = _snap(tmp_path)
    assert main(["ls", path]) == 0
    out = capsys.readouterr().out
    assert "0/m/w" in out and "float32" in out
    assert "primitive:int=12" in out
    assert main(["ls", path, "--rank", "0"]) == 0
    assert capsys.readouterr().out == out  # one rank: the per-rank view is the manifest


def test_cli_cat(tmp_path, capsys):
    path = _snap(tmp_path)
    assert main(["cat", path, "0/m/step"]) == 0
    assert capsys.readouterr().out.strip() == "12"
    assert main(["cat", path, "0/m/w", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == "[0. 1. 2. 3. 4. 5. 6. 7.]"


def test_cli_cat_default_device_needs_cuda(tmp_path, capsys):
    """Without ``--device`` a tensor goes to ``cuda``, as ``read_object``
    places it: on a host without one the command fails, never falls back."""
    path = _snap(tmp_path)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["cat", path, "0/m/w"])
    assert capsys.readouterr().out == ""
    # A primitive needs no device.
    assert main(["cat", path, "0/m/step"]) == 0
    assert capsys.readouterr().out.strip() == "12"


def test_cli_cat_prints_with_the_threshold(tmp_path, capsys):
    """Past 64 elements both routes elide the middle and keep four items
    at each edge; the process's torch print options are left as they were."""
    Snapshot.take(
        str(tmp_path / "snap"),
        {"m": StateDict({"f": torch.arange(100, dtype=torch.float32), "h": torch.arange(100).to(torch.bfloat16)})},
    )
    before = torch._tensor_str.PRINT_OPTS.threshold, torch._tensor_str.PRINT_OPTS.edgeitems
    assert main(["cat", str(tmp_path / "snap"), "0/m/f", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip()
    with np.printoptions(threshold=64, edgeitems=4):
        assert out == str(np.arange(100, dtype=np.float32))
    assert out.startswith("[ 0.  1.  2.  3.") and "..." in out
    assert main(["cat", str(tmp_path / "snap"), "0/m/h", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip()
    assert out.startswith("tensor([ 0.,  1.,  2.,  3.,  ..., 96., 97., 98., 99.]") and "bfloat16" in out
    assert (torch._tensor_str.PRINT_OPTS.threshold, torch._tensor_str.PRINT_OPTS.edgeitems) == before


def test_cli_steps(tmp_path, capsys):
    mgr = SnapshotManager(str(tmp_path / "run"))
    for step in (3, 7):
        mgr.save(step, {"m": StateDict({"w": torch.ones(8), "s": step})})
    assert main(["steps", str(tmp_path / "run")]) == 0
    out = capsys.readouterr().out
    assert "step_3" in out and "step_7" in out and "latest: 7" in out
    assert main(["steps", str(tmp_path / "empty")]) == 0
    assert capsys.readouterr().out == "no committed steps\n"


def test_cli_verify_clean_and_corrupt(tmp_path, capsys):
    path = str(tmp_path / "snap")
    snap = Snapshot.take(path, {"m": StateDict({"w": torch.arange(256, dtype=torch.float32)})})
    assert main(["verify", path]) == 0
    out = capsys.readouterr().out
    assert "0 corrupt" in out and "verified" in out

    # flip a byte in the payload
    entry = next(e for e in snap.get_manifest().values() if getattr(e, "location", None))
    with open(os.path.join(path, entry.location), "r+b") as f:
        f.seek((entry.byte_range or [0])[0] + 2)
        f.write(b"\xaa\xbb")
    assert main(["verify", path]) == 1
    out = capsys.readouterr().out
    assert "CORRUPT" in out
    assert out.splitlines()[-1] == "verified 0 payloads, 1 corrupt, 0 unreadable"

    # checksums off: a no-op audit is refused, not reported clean
    with knobs.override_env(knobs.CHECKSUM_ENV_VAR, "0"):
        assert main(["verify", path]) == 2
    assert "cannot verify: checksums disabled" in capsys.readouterr().out


def test_cli_verify_handles_object_entries(tmp_path, capsys):
    """Pickled objects (a set) carry checksums but no byte_range; verify
    audits them, not crash."""
    path = str(tmp_path / "objsnap")
    Snapshot.take(path, {"m": StateDict({"seen": {1, 2, 3}, "w": torch.ones(4, dtype=torch.float64)})})
    assert main(["verify", path]) == 0
    out = capsys.readouterr().out
    assert "0 corrupt" in out
    assert "verified 2 payloads" in out


def test_cli_diff(tmp_path, capsys):
    rng = np.random.default_rng(3)
    base = {
        "same": torch.from_numpy(rng.standard_normal(64).astype(np.float32)),
        "changed": torch.zeros(32),
        "gone": torch.ones(8),
        "step": 1,
    }
    Snapshot.take(str(tmp_path / "a"), {"m": StateDict(dict(base))})
    after = {
        "same": base["same"].clone(),
        "changed": base["changed"] + 1,
        "new": torch.ones(4),
        "step": 2,
    }
    Snapshot.take(str(tmp_path / "b"), {"m": StateDict(after)})

    rc = main(["diff", str(tmp_path / "a"), str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert rc == 1  # differences found
    assert "added  0/m/new" in out
    assert "removed  0/m/gone" in out
    assert "changed  0/m/changed" in out
    assert "changed  0/m/step" in out
    assert "0/m/same" not in out  # identical: not listed
    assert "1 identical" in out  # only "same" is unchanged

    # identical snapshots diff clean with rc 0
    rc = main(["diff", str(tmp_path / "a"), str(tmp_path / "a")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "0 added, 0 removed, 0 changed" in out

    # --limit caps each bucket
    rc = main(["diff", str(tmp_path / "a"), str(tmp_path / "b"), "--limit", "1"])
    out = capsys.readouterr().out
    assert rc == 1 and "   changed  ... and 1 more" in out


def test_cli_diff_without_digests_reports_unverified(tmp_path, capsys):
    """A structural match without digests surfaces as UNVERIFIED, never as
    a false 'identical'; and digest-asymmetric pairs (one side saved with
    recording off) do not flood 'changed'."""
    with knobs.override_env(knobs.CHECKSUM_ON_SAVE_ENV_VAR, "0"):
        # same shape/dtype, DIFFERENT content, no digests on either side
        Snapshot.take(str(tmp_path / "a"), {"m": StateDict({"w": torch.zeros(16)})})
        Snapshot.take(str(tmp_path / "b"), {"m": StateDict({"w": torch.ones(16)})})
    rc = main(["diff", str(tmp_path / "a"), str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert rc == 0  # no PROVEN difference...
    assert "unverified  0/m/w" in out
    assert "UNVERIFIED" in out  # ...but loudly not-identical
    assert "1 UNVERIFIED" in out

    # asymmetric: snapshot c HAS digests; same structure as b.
    Snapshot.take(str(tmp_path / "c"), {"m": StateDict({"w": torch.ones(16)})})
    rc = main(["diff", str(tmp_path / "b"), str(tmp_path / "c")])
    out = capsys.readouterr().out
    assert "changed" not in out.replace("0 changed", "")  # not flooded
    assert "unverified  0/m/w" in out
