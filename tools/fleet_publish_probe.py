#!/usr/bin/env python3
"""Where a fleet-telemetry publish's wall goes during a full-size async take.

    python3 tools/fleet_publish_probe.py [--takes N] [--n-layers L] [--stale S] [--ab]

On one CUDA GPU, takes the Llama-3-8B parameter set of chip_smoke.py
(built on the card from a seed) with ``Snapshot.async_take`` in pinned_host
mode, ``TPUSNAP_FLEET_TELEMETRY`` under ``.fleet_probe_tmp/`` beside the
repo (the checkout's file system), a 1 s interval and ``TPUSNAP_METRICS``
on (as the smoke's ``monitor_async_take``), ``N`` times; ``--stale``
sets the publishers' stale bound, whose half is the monitor's liveness
floor, and ``--ab`` takes every other pair with the spool off (on, off,
off, on, ...), so that the walls compare within one process.  For each
take it prints one JSON line:

- every publish: when it started (s after the call), the wall of
  ``build_entry`` and of the atomic write;
- every budget decision of the monitor's tick (elapsed, the op's publish
  wall so far, the verdict);
- the longest gaps of a thread that sleeps 1 ms in a loop (how long a
  Python thread can wait for the interpreter lock during the drain) and of
  a thread that ``os.stat``s the spool every 10 ms (the file system's
  metadata latency), with their medians;
- ``fleet.calibrated_overhead_s()`` right after ``wait()``, the wall of an
  ``os.sync()`` that flushes the take's dirty pages, and the calibration
  again after it.

Exits non-zero without CUDA.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--takes", type=int, default=2)
    parser.add_argument("--n-layers", type=int, default=None)
    parser.add_argument("--stale", type=float, default=None)
    parser.add_argument("--ab", action="store_true")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("fleet_publish_probe: torch.cuda.is_available() is false; needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import torchsnapshot_tpu_torch as ts
    from torchsnapshot_tpu_torch import knobs
    from torchsnapshot_tpu_torch.telemetry import fleet

    workdir = os.path.join(HERE, ".fleet_probe_tmp")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        params = cs.build_params(torch, args.n_layers or cs.N_LAYERS, 0)
        app_state = {"model": ts.StateDict(params)}
        torch.cuda.synchronize()
        print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi_line(),
                          "state_bytes": sum(t.numel() * t.element_size() for _, t in cs.leaves(params))}), flush=True)
        t0 = [0.0]
        publishes, budget = [], []
        build, write, within = fleet.build_entry, fleet._atomic_write_json, fleet.within_overhead_budget

        def timed_build(mon):
            begin = time.monotonic()
            try:
                return build(mon)
            finally:
                publishes.append({"at_s": round(begin - t0[0], 3), "build_s": round(time.monotonic() - begin, 6)})

        def timed_write(path, doc):
            begin = time.monotonic()
            try:
                write(path, doc)
            finally:
                if publishes and "write_s" not in publishes[-1]:
                    publishes[-1]["write_s"] = round(time.monotonic() - begin, 6)

        def logged_within(mon, elapsed_s):
            ok = within(mon, elapsed_s)
            budget.append((round(elapsed_s, 3), round(getattr(mon, "fleet_overhead_s", 0.0), 6), ok))
            return ok

        fleet.build_entry, fleet._atomic_write_json, fleet.within_overhead_budget = (
            timed_build, timed_write, logged_within)
        spool = os.path.join(workdir, "spool")
        for take in range(args.takes):
            publishes.clear()
            budget.clear()
            fleet.reset_process_totals()
            stop = threading.Event()
            gil, meta = [], []

            def gil_sampler():
                while not stop.is_set():
                    begin = time.monotonic()
                    time.sleep(0.001)
                    gil.append(time.monotonic() - begin - 0.001)

            def meta_sampler():
                while not stop.wait(0.01):
                    begin = time.monotonic()
                    os.stat(workdir)
                    meta.append(time.monotonic() - begin)

            samplers = [threading.Thread(target=gil_sampler), threading.Thread(target=meta_sampler)]
            snap = os.path.join(workdir, "snap")
            spool_on = not args.ab or take % 4 in (0, 3)
            with contextlib.ExitStack() as stack:
                stack.enter_context(knobs.override_async_staging("pinned_host"))
                stack.enter_context(knobs.override_metrics(True))
                if spool_on:
                    stack.enter_context(knobs.override_fleet_telemetry(spool))
                    stack.enter_context(knobs.override_fleet_telemetry_interval_s(1))
                    if args.stale is not None:
                        stack.enter_context(knobs.override_fleet_telemetry_stale_s(args.stale))
                t0[0] = time.monotonic()
                for th in samplers:
                    th.start()
                pending = ts.Snapshot.async_take(snap, app_state)
                while not pending.done():
                    time.sleep(0.25)
                pending.wait()
                total_s = time.monotonic() - t0[0]
                stop.set()
                for th in samplers:
                    th.join()
                seen = list(publishes)
                at_wait = fleet.calibrated_overhead_s()
                begin = time.monotonic()
                os.sync()
                sync_s = time.monotonic() - begin
                after_sync = fleet.calibrated_overhead_s()
            gil.sort()
            meta.sort()
            print(json.dumps({
                "take": take, "spool": spool_on, "total_s": round(total_s, 3), "publishes": seen,
                "budget_checks": budget,
                "lock_wait_s": {"n": len(gil), "median": round(gil[len(gil) // 2], 6), "max": [round(g, 4) for g in gil[-5:]]},
                "stat_s": {"n": len(meta), "median": round(meta[len(meta) // 2], 6), "max": [round(m, 4) for m in meta[-5:]]},
                "calibrated_at_wait": at_wait, "sync_s": round(sync_s, 3), "calibrated_after_sync": after_sync,
            }), flush=True)
            shutil.rmtree(snap)
        fleet.build_entry, fleet._atomic_write_json, fleet.within_overhead_budget = build, write, within
        return 0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
