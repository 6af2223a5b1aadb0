"""The two CLIs as one contract: ``python -m torchsnapshot_tpu_torch`` prints
what ``python -m torchsnapshot_tpu`` prints over the same files, with the
same exit code, whichever package wrote them.

- Each package writes a snapshot, a second one that differs from it, a
  copy with one flipped payload byte, a journal manager root (a full step,
  a delta segment, an uncommitted step) and a shared-store tenant; both
  CLIs read all of it: ``info``, ``ls``, ``ls --rank``, ``cat`` (the port
  with ``--device cpu``), ``steps``, ``verify`` (clean, flipped, a CAS
  step), ``diff``, ``stats``, ``history`` and the dry-run ``gc``.  Stdout
  and exit codes are equal; ``postmortem``'s text is equal but for the
  package named in its ``gc`` command.
- The subcommand set is the JAX set less the commands not ported yet, and
  each ported subcommand keeps the JAX parser's options (``dest``,
  ``default``, ``nargs``, flags, type and help), plus ``cat --device``;
  a nested parser (``profile diff``) is pinned the same way.  The
  telemetry verbs' output is held in tests/test_torch_cli_telemetry_parity.py."""

import argparse
import os
import shutil

import numpy as np
import pytest
import torch

import torchsnapshot_tpu_torch as ts
from torchsnapshot_tpu import Snapshot as JaxSnapshot
from torchsnapshot_tpu import StateDict as JaxStateDict
from torchsnapshot_tpu.__main__ import main as jax_main
from torchsnapshot_tpu.manager import SnapshotManager as JaxManager
from torchsnapshot_tpu_torch import knobs
from torchsnapshot_tpu_torch.__main__ import main as port_main
from torchsnapshot_tpu_torch.serialization import state_from_numpy

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

NOT_PORTED = {"lint", "repack", "warm", "serve", "rollout"}


def _state(step=1, changed=False):
    rng = np.random.default_rng(7)
    state = {
        "w": rng.standard_normal((500, 200)).astype(np.float32),
        "b": rng.standard_normal(64).astype(np.float32),
        "ids": np.arange(100, dtype=np.int64),
        "step": step,
    }
    if changed:
        state["b"] = state["b"] + 1
        state["new"] = np.ones(4, np.float32)
        del state["ids"]
    return state


def _save(writer, path, state, manager=None, step=None):
    if writer == "port":
        app = {"m": ts.StateDict(state_from_numpy(dict(state)))}
        if manager is None:
            ts.Snapshot.take(path, app)
        else:
            manager.save(step, app)
    else:
        app = {"m": JaxStateDict(dict(state))}
        if manager is None:
            JaxSnapshot.take(path, app)
        else:
            manager.save(step, app)


def _manager(writer, root, **kwargs):
    return ts.SnapshotManager(root, **kwargs) if writer == "port" else JaxManager(root, **kwargs)


def _write_all(writer, base):
    """The files both CLIs read, written by ``writer``; returns their paths."""
    p = {k: os.path.join(base, k) for k in ("a", "b", "flipped", "root", "store", "tenant")}
    _save(writer, p["a"], _state())
    _save(writer, p["b"], _state(2, changed=True))
    shutil.copytree(p["a"], p["flipped"])
    md = ts.Snapshot(p["a"]).metadata
    entry = md.manifest["0/m/w"]
    entry = entry.chunks[0].tensor if hasattr(entry, "chunks") else entry
    with open(os.path.join(p["flipped"], entry.location), "r+b") as f:
        f.seek((entry.byte_range or [0])[0] + 100)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0x40]))
    with knobs.override_journal(True):
        mgr = _manager(writer, p["root"])
        _save(writer, None, _state(), mgr, 0)
        _save(writer, None, _state(1, changed=True), mgr, 1)
    os.makedirs(os.path.join(p["root"], "step_9"))
    with open(os.path.join(p["root"], "step_9", "0%2Fm%2Fw"), "wb") as f:
        f.write(b"junk")
    _save(writer, None, _state(), _manager(writer, p["tenant"], store=p["store"]), 3)
    return p


def _commands(p):
    return [
        ["info", p["a"]],
        ["info", p["root"] + "/step_0"],
        ["info", p["root"] + "/seg_1"],
        ["info", p["tenant"] + "/step_3"],
        ["ls", p["a"]],
        ["ls", p["a"], "--rank", "0"],
        ["ls", p["root"] + "/seg_1"],
        ["cat", p["a"], "0/m/b"],
        ["cat", p["a"], "0/m/ids"],
        ["cat", p["a"], "0/m/step"],
        ["steps", p["root"]],
        ["steps", p["tenant"]],
        ["verify", p["a"]],
        ["verify", p["flipped"]],
        ["verify", p["root"] + "/step_0"],
        ["verify", p["tenant"] + "/step_3"],
        ["diff", p["a"], p["b"]],
        ["diff", p["a"], p["a"]],
        ["diff", p["root"] + "/step_0", p["root"] + "/seg_1", "--limit", "1"],
        ["stats", p["a"]],
        ["stats", p["root"] + "/seg_1"],
        ["stats", p["tenant"] + "/step_3"],
        ["history", p["root"]],
        ["history", p["root"], "--json"],
        ["gc", p["root"]],
        ["gc", p["tenant"]],
        ["postmortem", p["root"]],
    ]


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_both_clis_print_alike(tmp_path, capsys, writer):
    p = _write_all(writer, str(tmp_path))
    differ = []
    for argv in _commands(p):
        port_argv = argv + ["--device", "cpu"] if argv[0] == "cat" else argv
        jax_rc, jax_out = _run(jax_main, argv, capsys)
        port_rc, port_out = _run(port_main, port_argv, capsys)
        if argv[0] == "postmortem":
            port_out = port_out.replace("python -m torchsnapshot_tpu_torch ", "python -m torchsnapshot_tpu ")
        if (jax_rc, jax_out) != (port_rc, port_out):
            differ.append((argv[0], argv[1:], jax_rc, port_rc, jax_out, port_out))
    assert differ == []
    # The reads covered what they should: a corrupt payload, a journal
    # delta, the store lines, the uncommitted step.
    assert _run(port_main, ["verify", p["flipped"]], capsys)[0] == 1
    assert "journal:     delta segment over step_0" in _run(port_main, ["info", p["root"] + "/seg_1"], capsys)[1]
    assert f"shared CAS at {p['store']}" in _run(port_main, ["info", p["tenant"] + "/step_3"], capsys)[1]
    assert "orphan step_9 (no .snapshot_metadata)" in _run(port_main, ["gc", p["root"]], capsys)[1]


class _Parsed(Exception):
    pass


def _parser_of(main):
    """The ArgumentParser ``main`` builds, caught at its ``parse_args``."""
    captured = []

    def _capture(self, args=None, namespace=None):
        captured.append(self)
        raise _Parsed()

    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = _capture
    try:
        with pytest.raises(_Parsed):
            main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    return captured[0]


def _subparsers(parser):
    (action,) = [a for a in parser._actions if isinstance(a, argparse._SubParsersAction)]
    return action


def test_subcommand_set_is_the_jax_set_less_the_unported():
    jax_cmds = set(_subparsers(_parser_of(jax_main)).choices)
    port_cmds = set(_subparsers(_parser_of(port_main)).choices)
    assert NOT_PORTED <= jax_cmds
    assert port_cmds == jax_cmds - NOT_PORTED
    assert port_cmds == {
        "info", "ls", "cat", "steps", "gc", "verify", "diff", "cp", "stats", "history", "postmortem",
        "trace", "analyze", "profile", "top",
    }
    for cmd in NOT_PORTED:
        with pytest.raises(SystemExit) as e:
            port_main([cmd, "x"])
        assert e.value.code == 2  # argparse: invalid choice


def _options(sub):
    return [
        (a.dest, tuple(a.option_strings), a.default, a.nargs, a.type, a.help, type(a).__name__)
        for a in sub._actions
        if not isinstance(a, argparse._HelpAction)
    ]


def _fn_name(parser):
    fn = parser.get_default("fn")
    return None if fn is None else fn.__name__


def _assert_same_subcommands(jax_sub, port_sub, path=()):
    """Each of ``port_sub``'s commands keeps the JAX command's options, help
    and handler name, and so does each command of a nested parser."""
    jax_help = {c.dest: c.help for c in jax_sub._choices_actions}
    port_help = {c.dest: c.help for c in port_sub._choices_actions}
    for cmd, sub in port_sub.choices.items():
        want = _options(jax_sub.choices[cmd])
        got = _options(sub)
        if path + (cmd,) == ("cat",):
            (device,) = [o for o in got if o[0] == "device"]
            assert device[1:4] == (("--device",), "cuda", None)
            got.remove(device)
        assert got == want, path + (cmd,)
        assert port_help[cmd] == jax_help[cmd], path + (cmd,)
        assert _fn_name(sub) == _fn_name(jax_sub.choices[cmd]), path + (cmd,)
        nested = [a for a in sub._actions if isinstance(a, argparse._SubParsersAction)]
        if nested:
            assert set(nested[0].choices) == set(_subparsers(jax_sub.choices[cmd]).choices), path + (cmd,)
            _assert_same_subcommands(_subparsers(jax_sub.choices[cmd]), nested[0], path + (cmd,))


def test_ported_subcommands_keep_the_jax_options():
    port_parser = _parser_of(port_main)
    port_sub = _subparsers(port_parser)
    _assert_same_subcommands(_subparsers(_parser_of(jax_main)), port_sub)
    assert set(port_sub.choices["profile"]._actions[-1].choices) == {"diff"}
    assert _fn_name(port_sub.choices["profile"]._actions[-1].choices["diff"]) == "cmd_profile_diff"
    assert port_parser.prog == "python -m torchsnapshot_tpu_torch"


def test_cat_of_a_numpy_dtype_prints_as_the_jax_cli(tmp_path, capsys):
    """Past the threshold the port prints a float32 tensor as the JAX CLI
    prints its array; a bfloat16 tensor, which numpy lacks, prints through
    torch with the same edge items."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((20, 30)).astype(np.float32)
    JaxSnapshot.take(str(tmp_path / "s"), {"m": JaxStateDict({"w": w})})
    jax_rc, jax_out = _run(jax_main, ["cat", str(tmp_path / "s"), "0/m/w"], capsys)
    port_rc, port_out = _run(port_main, ["cat", str(tmp_path / "s"), "0/m/w", "--device", "cpu"], capsys)
    assert (port_rc, port_out) == (jax_rc, jax_out) == (0, port_out)
    assert "..." in port_out
    ts.Snapshot.take(str(tmp_path / "h"), {"m": ts.StateDict({"h": torch.from_numpy(w).to(torch.bfloat16)})})
    rc, out = _run(port_main, ["cat", str(tmp_path / "h"), "0/m/h", "--device", "cpu"], capsys)
    assert rc == 0 and out.startswith("tensor([[") and "dtype=torch.bfloat16" in out and "..." in out


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for fname in files:
            full = os.path.join(dirpath, fname)
            with open(full, "rb") as f:
                out[os.path.relpath(full, root)] = f.read()
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cp_through_both_clis(tmp_path, capsys, writer):
    """``cp --verify`` of one source through each CLI: the same line, the
    same replica file for file, and both audits of each replica equal."""
    src = str(tmp_path / "src")
    _save(writer, src, _state())
    dsts = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        dsts[name] = str(tmp_path / f"dst_{name}")
        assert _run(main, ["cp", src, dsts[name], "--verify"], capsys) == (0, f"copied {src} -> {dsts[name]} (verified)\n")
    # A replica holds the payloads and the marker; the source's telemetry
    # sidecars stay with it.
    payloads = {k: v for k, v in _tree(src).items() if not k.startswith("telemetry/")}
    assert _tree(dsts["jax"]) == _tree(dsts["port"]) == payloads
    for dst in dsts.values():
        jax_res, port_res = _run(jax_main, ["verify", dst], capsys), _run(port_main, ["verify", dst], capsys)
        assert jax_res == port_res == (0, "compression: none\nverified 3 payloads, 0 corrupt, 0 unreadable\n")
