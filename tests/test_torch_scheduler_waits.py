"""The port's scheduler records the two wait phases that name a throttled op
(``torchsnapshot_tpu_torch/scheduler.py``), under the JAX scheduler's
conditions:

- ``io_slot_wait``: a write or read request's wait for its I/O slot, when
  over 1 ms, once per attempt.  Each request holds its own slot through
  its storage call; a request the fs plugin micro-batches
  (``TPUSNAP_NATIVE_BATCH``) holds it until its batch has flushed, so the
  wait is charged per request, never per batch.
- ``budget_wait``: the wall of each pipeline turn in which the memory budget
  binds: the queue head cannot be admitted while nothing stages and fewer
  writes than the cap run (write side), or while fewer reads than the cap
  run (read side).

Every payload write (or read) is held a set time by a latency fault, so no
case depends on the host's speed: the one duration checked is a lower
bound that the injected latency sets.  A contiguous CPU tensor is viewed in place and
costs no staging budget, so the write-side budget case frames its payloads
(zstd), whose frames the budget counts, as it counts a CUDA tensor's pinned
buffer.  Each throttled case also reads the port's trace through
``python -m torchsnapshot_tpu_torch analyze --json``, whose matching group
wall must be above 0, and the same takes under both packages, with the same
knobs, record the same set of wait phases."""

import asyncio
import contextlib
import glob
import json
import os

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jax_pkg
import torchsnapshot_tpu_torch as ts
from torchsnapshot_tpu_torch import knobs, phase_stats, scheduler
from torchsnapshot_tpu_torch.__main__ import main as port_main
from torchsnapshot_tpu_torch.retry import StorageTransientError
from torchsnapshot_tpu_torch.telemetry import trace

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

WAITS = {"io_slot_wait", "budget_wait"}
N_TENSORS = 4
ELEMS = 1 << 16  # 256 KiB of float32 each: one request each, above the codec's 64 KiB floor
LATENCY_S = 0.05
# Every payload write holds its slot for the latency; the commit marker and
# the sidecars go unhindered.
WRITE_LATENCY = f"write:1+:latency:{LATENCY_S}@0/*"
READ_LATENCY = f"read:1+:latency:{LATENCY_S}@0/*"


def _arrays():
    rng = np.random.default_rng(19)
    return {f"w{i}": rng.standard_normal(ELEMS).astype(np.float32) for i in range(N_TENSORS)}


# The knobs of each case, beside the faults and the trace directory.
CASES = {
    "io_cap_1": lambda: [knobs.override_max_per_rank_io_concurrency(1)],
    "budget_one_request": lambda: [
        knobs.override_compression("zstd"),
        knobs.override_per_rank_memory_budget_bytes(ELEMS * 4),
    ],
    "ample": lambda: [],
}
EXPECTED = {"io_cap_1": {"io_slot_wait"}, "budget_one_request": {"budget_wait"}, "ample": set()}


def _take(pkg, case, root, trace_dir):
    arrs = _arrays()
    with contextlib.ExitStack() as stack:
        for cm in CASES[case]():
            stack.enter_context(cm)
        stack.enter_context(knobs.override_batching_disabled(True))
        stack.enter_context(knobs.override_faults(WRITE_LATENCY))
        stack.enter_context(knobs.override_trace_dir(trace_dir))
        if pkg == "port":
            return ts.Snapshot.take(root, {"m": ts.StateDict({k: torch.from_numpy(v) for k, v in arrs.items()})})
        return jax_pkg.Snapshot.take(root, {"m": jax_pkg.StateDict(dict(arrs))})


def _spans(trace_dir, kind):
    """Span name -> [count, total seconds] in ``kind``'s trace files."""
    out: dict = {}
    for path in glob.glob(os.path.join(trace_dir, f"{kind}-*{trace.TRACE_FILE_SUFFIX}")):
        with open(path, encoding="utf-8") as f:
            for ev in json.load(f)["traceEvents"]:
                if ev.get("ph") == "X":
                    row = out.setdefault(ev["name"], [0, 0.0])
                    row[0] += 1
                    row[1] += ev["dur"] / 1e6
    return out


def _analyze_groups(trace_dir, capsys, kind):
    capsys.readouterr()
    assert port_main(["analyze", trace_dir, "--json"]) == 0
    (op,) = [op for op in json.loads(capsys.readouterr().out)["ops"] if op["kind"] == kind]
    return op


def test_io_cap_of_one_records_io_slot_wait(tmp_path, capsys):
    trace_dir = str(tmp_path / "traces")
    _take("port", "io_cap_1", str(tmp_path / "snap"), trace_dir)
    spans = _spans(trace_dir, "take")
    # Every request but the first waits for the one slot, about one held
    # write each; the budget never binds (a CPU tensor costs none).
    assert spans["io_slot_wait"][0] == N_TENSORS - 1
    assert spans["io_slot_wait"][1] >= (N_TENSORS - 1) * LATENCY_S * 0.9
    assert "budget_wait" not in spans
    op = _analyze_groups(trace_dir, capsys, "take")
    assert op["groups"]["io_concurrency"] > 0
    assert op["phases"]["io_slot_wait"]["group"] == "io_concurrency"


def test_budget_of_one_request_records_budget_wait_on_the_write_side(tmp_path, capsys):
    trace_dir = str(tmp_path / "traces")
    _take("port", "budget_one_request", str(tmp_path / "snap"), trace_dir)
    spans = _spans(trace_dir, "take")
    # One request stages at a time: while its frame's write is held, the
    # next cannot be admitted, nothing stages and 15 slots sit idle.
    assert spans["budget_wait"][0] >= N_TENSORS - 1
    assert spans["budget_wait"][1] >= (N_TENSORS - 1) * LATENCY_S * 0.9
    assert "io_slot_wait" not in spans
    op = _analyze_groups(trace_dir, capsys, "take")
    assert op["groups"]["memory_budget"] > 0
    assert op["phases"]["budget_wait"]["group"] == "memory_budget"


def test_budget_of_one_request_records_budget_wait_on_the_read_side(tmp_path, capsys):
    trace_dir = str(tmp_path / "traces")
    arrs = _arrays()
    with knobs.override_batching_disabled(True):
        state = {"m": ts.StateDict({k: torch.from_numpy(v) for k, v in arrs.items()})}
        snap = ts.Snapshot.take(str(tmp_path / "snap"), state)
    dst = {"m": ts.StateDict({k: torch.zeros(ELEMS) for k in arrs})}
    with knobs.override_per_rank_memory_budget_bytes(ELEMS * 4), knobs.override_faults(
        READ_LATENCY
    ), knobs.override_trace_dir(trace_dir):
        snap.restore(dst)
    assert all(np.array_equal(dst["m"][k].numpy(), v) for k, v in arrs.items())
    spans = _spans(trace_dir, "restore")
    # One read in flight at a time; each later head waits out a held read.
    assert spans["budget_wait"][0] >= N_TENSORS - 1
    assert spans["budget_wait"][1] >= (N_TENSORS - 1) * LATENCY_S * 0.9
    assert "io_slot_wait" not in spans
    op = _analyze_groups(trace_dir, capsys, "restore")
    assert op["groups"]["memory_budget"] > 0


def test_ample_budget_and_cap_record_neither(tmp_path):
    trace_dir = str(tmp_path / "traces")
    snap = _take("port", "ample", str(tmp_path / "snap"), trace_dir)
    dst = {"m": ts.StateDict({k: torch.zeros(ELEMS) for k in _arrays()})}
    with knobs.override_faults(READ_LATENCY), knobs.override_trace_dir(trace_dir):
        snap.restore(dst)
    assert all(np.array_equal(dst["m"][k].numpy(), v) for k, v in _arrays().items())
    for kind in ("take", "restore"):
        spans = _spans(trace_dir, kind)
        assert spans, kind
        assert not WAITS & set(spans), (kind, sorted(spans))


def test_a_retried_request_is_charged_for_each_slot_wait():
    """Attempt 1 waits for a slot held by another request, fails
    transiently, and in its backoff that request takes the slot again:
    attempt 2 waits too, and both waits are recorded."""

    async def _drive():
        sem = asyncio.Semaphore(1)
        holders = []

        async def hold():
            async with sem:
                await asyncio.sleep(LATENCY_S)

        holders.append(asyncio.ensure_future(hold()))
        await asyncio.sleep(0)  # the holder has the slot
        attempts = []

        async def fn():
            attempts.append(1)
            if len(attempts) == 1:
                holders.append(asyncio.ensure_future(hold()))  # queued behind this attempt's slot
                await asyncio.sleep(0)
                raise StorageTransientError("injected")

        await scheduler._with_retries(fn, "write", "0/m/w", 0, sem)
        await asyncio.gather(*holders)
        return len(attempts)

    before = phase_stats.snapshot()
    with knobs.override_retry_base_s(0.0001):
        attempts = asyncio.run(_drive())
    waits = phase_stats.delta(before).get("io_slot_wait", {})
    assert attempts == 2
    assert waits.get("n") == 2
    assert waits["s"] >= 2 * LATENCY_S * 0.9


@pytest.mark.parametrize("case", sorted(CASES))
def test_both_packages_record_the_same_wait_phases(tmp_path, case):
    found = {}
    for pkg in ("jax", "port"):
        trace_dir = str(tmp_path / f"{pkg}_traces")
        _take(pkg, case, str(tmp_path / pkg), trace_dir)
        found[pkg] = WAITS & set(_spans(trace_dir, "take"))
    assert found["port"] == found["jax"] == EXPECTED[case]
