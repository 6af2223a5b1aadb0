"""Device-side async-snapshot staging: ``async_take`` returns once the app
state is snapshot-stable, before any storage I/O.

Counterpart of ``torchsnapshot_tpu/device_staging.py``.  The contract of
``async_take`` is that the caller may mutate, free or reuse every tensor
the moment it returns.  Host staging (stage everything to host RAM before
returning) bounds the training stall below by D2H bandwidth and the disk;
on the card the same contract is met by copying the state:

- ``device``: one D2D copy of each CUDA tensor into fresh device memory
  (the write pieces of one leaf share one copy of it), at HBM bandwidth,
  on a side stream (``_device_copy_batch``); the D2H and
  storage drain run on the background thread;
- ``pinned_host``: one non-blocking D2H copy of each CUDA tensor into a
  page-locked host buffer, on a side stream (``_pinned_host_copy_batch``);
  the staged leaf is that pinned CPU tensor, which the background drain
  writes in place.

Mode selection (``TPUSNAP_ASYNC_STAGING``):

- ``auto`` (default): ``pinned_host`` when pinned host memory is usable
  (always on CUDA, unless a recent failure put it in backoff), else
  ``device`` when device memory has room for a full copy, else ``host``;
- ``pinned_host`` / ``device``: force that placement, falling back down the
  same chain, with an ``async_take.staging_downgrade`` event, when it is
  unusable;
- ``host``: stage to host memory on the caller's thread before returning.

What is copied before return, by leaf type (both device modes):

- CUDA tensors: as above (``nn.Parameter``s and non-contiguous tensors
  included; copies are contiguous);
- CPU tensors (pinned ones too) and numpy arrays: a host copy.  JAX arrays
  are immutable and the JAX package leaves host-resident ones in place;
  torch tensors and numpy arrays are not;
- other objects: pickled now into a :class:`PrePickled`;
- primitives and numpy scalars: kept (they are captured at plan time or
  immutable).

The residency predicate (:func:`_is_device_resident`) and
``staging.pinned_empty`` are the seams the CPU tests widen to drive the
device modes without a card; the copy helpers make stream and event calls
only for CUDA tensors.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from . import knobs, phase_stats, staging
from .event import Event
from .event_handlers import log_event
from .manifest import PrimitiveEntry
from .serialization import PrePickled, tensor_u8

logger = logging.getLogger(__name__)

# Fraction of free device memory a device-mode copy may claim; the rest is
# slack for the training step's own activations resuming under the drain.
_HBM_HEADROOM_FRACTION = 0.8

MODES = ("auto", "device", "pinned_host", "host")

# Conservativeness order for the cross-rank mode agreement: host stages on
# the caller's thread (always works), device needs device-memory headroom,
# pinned_host needs healthy pinned host memory.
_MODE_RANK = {"host": 0, "device": 1, "pinned_host": 2}


def configured_mode() -> str:
    mode = os.environ.get(knobs.ASYNC_STAGING_ENV_VAR, "auto").lower()
    if mode not in MODES:
        raise ValueError(
            f"{knobs.ASYNC_STAGING_ENV_VAR} must be one of "
            f"{'/'.join(MODES)}, got {mode!r}"
        )
    return mode


def _is_device_resident(obj: Any) -> bool:
    """A leaf that needs a D2H copy to stage: a CUDA tensor."""
    return staging.is_cuda_tensor(obj)


def _device_resident_tensors(flattened: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {path: obj for path, obj in flattened.items() if _is_device_resident(obj)}


def _platform_of(t: torch.Tensor) -> str:
    return t.device.type


def _supports_pinned_host(t: torch.Tensor) -> bool:
    """Page-locked host memory needs CUDA's host allocator; a host-resident
    source copies into any host buffer."""
    return t.device.type == "cpu" or (t.is_cuda and torch.cuda.is_available())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _hbm_headroom_fits(tensors: Dict[str, torch.Tensor]) -> bool:
    """True when every CUDA device touched has room for its share of the
    copy: free memory plus what the caching allocator holds reserved but
    unallocated, times the headroom fraction.  Host-resident tensors always
    fit (host RAM is the pool)."""
    need: Dict[torch.device, int] = {}
    for t in tensors.values():
        if t.is_cuda:
            need[t.device] = need.get(t.device, 0) + _nbytes(t)
    for device, nbytes in need.items():
        free, _total = torch.cuda.mem_get_info(device)
        reserved_free = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
        if nbytes > (free + reserved_free) * _HBM_HEADROOM_FRACTION:
            return False
    return True


# Per-platform pinned_host health.  A failure records against the platform
# with a timestamp; for the next TPUSNAP_PINNED_HOST_RETRY_S seconds the
# mode is skipped, then one retry is allowed, so a transient failure never
# downgrades a long-running trainer for good.
_PINNED_HOST_HEALTH: Dict[str, Dict[str, float]] = {}


def _pinned_host_usable(platform: str) -> bool:
    """Healthy, or past the retry backoff.  A pure predicate: probes do not
    burn the retry clock."""
    health = _PINNED_HOST_HEALTH.get(platform)
    if health is None:
        return True
    return time.monotonic() - health["last_failure"] > knobs.get_pinned_host_retry_s()


def record_pinned_host_failure(platform: str) -> None:
    health = _PINNED_HOST_HEALTH.setdefault(platform, {"failures": 0.0, "last_failure": 0.0})
    health["failures"] += 1
    health["last_failure"] = time.monotonic()


def reset_pinned_host_health() -> None:
    """Forget recorded pinned_host failures, so the next snapshot tries the
    preferred mode again."""
    _PINNED_HOST_HEALTH.clear()


def _local_staging_signals(flattened: Dict[str, Any], emit_events: bool = False) -> Dict[str, Any]:
    """This process's preferred placement and what it could execute: the
    cross-rank agreement needs both.  ``emit_events`` is True only for the
    resolution that feeds a staging, so probes never emit downgrade
    events."""
    mode = configured_mode()
    if mode == "host":
        return {"mode": "host", "device_fits": True}
    tensors = _device_resident_tensors(flattened)
    if not tensors:
        # Nothing needs a D2H copy: host staging is already quick here, and
        # this rank's vote is compatible with any mode.
        return {"mode": "host", "device_fits": True, "any_ok": True}
    # One probe per platform, so a mixed state cannot decide pinned_host
    # support from whichever tensor iterates first.
    probes: Dict[str, torch.Tensor] = {}
    for t in tensors.values():
        probes.setdefault(_platform_of(t), t)
    pinned_ok = all(
        _supports_pinned_host(t) and _pinned_host_usable(platform)
        for platform, t in probes.items()
    )
    device_fits = _hbm_headroom_fits(tensors)
    if mode == "pinned_host" and not pinned_ok:
        logger.warning(
            "TPUSNAP_ASYNC_STAGING=pinned_host but pinned host memory is not "
            "(healthily) usable; falling back to device-copy staging"
        )
        if emit_events:
            _log_downgrade_event("pinned_host", "device", "no healthy pinned host memory")
        mode = "device"
    if mode == "device" or (mode == "auto" and not pinned_ok):
        if device_fits:
            return {"mode": "device", "device_fits": True}
        logger.warning(
            "Insufficient device memory for device-copy async staging; "
            "falling back to host staging"
        )
        if emit_events:
            _log_downgrade_event("device", "host", "insufficient device memory for a device copy")
        return {"mode": "host", "device_fits": False}
    return {"mode": "pinned_host", "device_fits": device_fits}


def resolve_mode(flattened: Dict[str, Any], pg: Any = None, emit_events: bool = False) -> str:
    """The placement this app state will actually use.

    When ``pg`` spans more than one rank, the locally resolved signals are
    all-gathered on the caller's thread and the most conservative mode wins
    (host < device < pinned_host), so every rank stages the same way; a
    rank with nothing to stage votes "compatible with anything".  Pure by
    default: ``emit_events=True`` is passed only by the caller that stages.
    """
    signals = _local_staging_signals(flattened, emit_events=emit_events)
    mode = signals["mode"]
    if pg is not None and pg.get_world_size() > 1:
        gathered = pg.all_gather_object(signals)
        votes = [s for s in gathered if not s.get("any_ok")]
        if not votes:
            return mode
        modes = [s["mode"] for s in votes]
        agreed = min(modes, key=lambda m: _MODE_RANK.get(m, 0))
        if agreed == "device" and not all(s.get("device_fits", True) for s in votes):
            # A peer forced the fleet off pinned_host, but some rank cannot
            # hold a full device copy: everyone takes host.
            agreed = "host"
        if agreed != mode:
            logger.info(
                "Async staging mode %r downgraded to %r by cross-rank agreement "
                "(gathered: %s)",
                mode,
                agreed,
                modes,
            )
            if emit_events:
                _log_downgrade_event(mode, agreed, f"cross-rank agreement (gathered: {modes})")
        mode = agreed
    return mode


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    """A side stream that first waits on the caller's current stream, so a
    copy sees every write the caller already enqueued."""
    stream = torch.cuda.Stream(device=device)
    stream.wait_stream(torch.cuda.current_stream(device))
    return stream


def _contiguous_copy(t: torch.Tensor) -> torch.Tensor:
    """A fresh contiguous tensor with ``t``'s values, on ``t``'s device and
    current stream.  Contiguous sources copy their bytes through uint8
    views, which every dtype of the registry supports (``copy_`` has no
    kernel for the sub-byte ``int4``/``uint4``).  The allocation is timed
    as phase ``stage_alloc``."""
    src = t.detach().resolve_conj().resolve_neg()
    with phase_stats.timed("stage_alloc", _nbytes(src)):
        out = torch.empty_like(src, memory_format=torch.contiguous_format)
    if src.is_contiguous():
        tensor_u8(out).copy_(tensor_u8(src))
    else:
        out.copy_(src)
    return out


def _byte_offset(t: torch.Tensor) -> int:
    return t.data_ptr() - t.untyped_storage().data_ptr()


def _whole_storage_groups(tensors: List[torch.Tensor], idxs: List[int]) -> List[List[int]]:
    """Groups of two or more of ``idxs`` whose tensors are contiguous views
    that tile one storage exactly: the chunks or pieces of a leaf that
    this rank writes in full (always so at world size 1)."""
    by_storage: Dict[int, List[int]] = {}
    for i in idxs:
        t = tensors[i]
        if t.numel() and t.is_contiguous() and not (t.is_conj() or t.is_neg()):
            by_storage.setdefault(t.untyped_storage().data_ptr(), []).append(i)
    groups = []
    for members in by_storage.values():
        if len(members) < 2:
            continue
        end = 0
        for start, nbytes in sorted((_byte_offset(tensors[i]), _nbytes(tensors[i])) for i in members):
            if start != end:
                break
            end += nbytes
        else:
            if end == tensors[members[0]].untyped_storage().nbytes():
                groups.append(members)
    return groups


def _copy_views(tensors: List[torch.Tensor], idxs: List[int], out: List[Any]) -> None:
    """Fill ``out[i]`` for ``idxs`` on the current stream: one copy of each
    storage that a group of views tiles (each view then a view of that
    copy), one copy of every other tensor."""
    grouped = set()
    for members in _whole_storage_groups(tensors, idxs):
        first = tensors[members[0]]
        storage = torch.empty(0, dtype=torch.uint8, device=first.device).set_(first.untyped_storage())
        staged = _contiguous_copy(storage)
        for i in members:
            t = tensors[i]
            begin = _byte_offset(t)
            out[i] = staged[begin : begin + _nbytes(t)].view(t.dtype).view(t.shape)
        grouped.update(members)
    for i in idxs:
        if i not in grouped:
            out[i] = _contiguous_copy(tensors[i])


def _device_copy_batch(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Fresh contiguous copies in the same device memory: one side stream
    per CUDA device, an event per device, every event synchronized before
    return.  Views that tile one storage share one copy of it, so a leaf
    cut into chunks or pieces costs one allocation.  Each copy is
    allocated under its side stream, so the caching allocator ties its
    block to that stream."""
    out: List[Any] = [None] * len(tensors)
    groups: Dict[torch.device, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.device, []).append(i)
    events = []
    for device, idxs in groups.items():
        if device.type != "cuda":
            _copy_views(tensors, idxs, out)
            continue
        with torch.cuda.device(device):
            stream = _side_stream(device)
            with torch.cuda.stream(stream):
                _copy_views(tensors, idxs, out)
                event = torch.cuda.Event()
                event.record(stream)
        events.append(event)
    for event in events:
        event.synchronize()
    return out


def _pinned_host_copy_batch(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor's bytes in a page-locked host buffer (``staging.pinned_empty``),
    viewed with the source's dtype and shape: non-blocking D2H copies on one
    side stream per CUDA device, every event synchronized before return.
    The wait lands in the ``d2h`` phase with the bytes copied."""
    out: List[Any] = [None] * len(tensors)
    pending = []  # (event, sources kept alive until it fires, bytes)
    groups: Dict[torch.device, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.device, []).append(i)
    for device, idxs in groups.items():
        if device.type != "cuda":
            for i in idxs:
                src = tensors[i].detach().contiguous()
                host = staging.pinned_empty(_nbytes(src))
                host.copy_(tensor_u8(src))
                out[i] = host.view(src.dtype).reshape(src.shape)
            continue
        nbytes = 0
        keep = []
        with torch.cuda.device(device):
            stream = _side_stream(device)
            with torch.cuda.stream(stream):
                for i in idxs:
                    src = tensors[i].detach()
                    if not src.is_contiguous():
                        src = src.contiguous()  # on the side stream
                    host = staging.pinned_empty(_nbytes(src))
                    host.copy_(tensor_u8(src), non_blocking=True)
                    keep.append(src)
                    nbytes += _nbytes(src)
                    out[i] = host.view(src.dtype).reshape(src.shape)
                event = torch.cuda.Event()
                event.record(stream)
        pending.append((event, keep, nbytes))
    for event, _keep, nbytes in pending:
        begin = time.monotonic()
        event.synchronize()
        phase_stats.add("d2h", time.monotonic() - begin, nbytes)
    return out


def _host_copy(obj: Any) -> Any:
    """A copy of a CPU tensor or numpy array that no caller can reach."""
    if isinstance(obj, torch.Tensor):
        return _contiguous_copy(obj)
    return obj.copy()


def stage_app_state(flattened: Dict[str, Any], mode: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Replace every leaf the caller could mutate with a snapshot-stable
    copy, per the resolved ``mode`` ("device" or "pinned_host").  Returns
    the new flattened dict and a stats dict for events and benchmarks."""
    begin = time.monotonic()
    tensors = _device_resident_tensors(flattened)
    paths = list(tensors)
    copy_bytes = sum(_nbytes(t) for t in tensors.values())
    downgraded_from = None
    downgrade_reason = None
    if mode == "pinned_host":
        try:
            copies = _pinned_host_copy_batch([tensors[p] for p in paths])
        except Exception as e:  # noqa: BLE001 — recorded, downgraded, evented
            # The batch spans every platform in the state and the exception
            # does not say which one broke: quarantine them all.
            platforms = sorted({_platform_of(t) for t in tensors.values()})
            for platform in platforms:
                record_pinned_host_failure(platform)
            failures = max(int(_PINNED_HOST_HEALTH[p]["failures"]) for p in platforms)
            downgraded_from = "pinned_host"
            downgrade_reason = (
                f"{type(e).__name__}: {e} (failure #{failures} on {'/'.join(platforms)})"
            )
            # The device copy is safe only when device memory has room (a
            # pinned_host rank never consulted the headroom check); else the
            # caller's catch-all stages to host.
            if not _hbm_headroom_fits(tensors):
                raise
            logger.warning("pinned_host staging failed (%s); using device-copy staging", type(e).__name__)
            _log_downgrade_event("pinned_host", "device", downgrade_reason)
            mode = "device"
            copies = _device_copy_batch([tensors[p] for p in paths])
    elif mode == "device":
        copies = _device_copy_batch([tensors[p] for p in paths])
    else:
        raise ValueError(f"stage_app_state cannot run in mode {mode!r}")

    copied = dict(zip(paths, copies))
    out: Dict[str, Any] = {}
    for path, obj in flattened.items():
        if path in copied:
            out[path] = copied[path]
        elif isinstance(obj, (torch.Tensor, np.ndarray)):
            out[path] = _host_copy(obj)
        elif isinstance(obj, np.generic) or _is_prepare_time_safe(obj):
            out[path] = obj
        else:
            # Objects are pickled at staging time on the host path; here
            # staging runs in the background, so capture the bytes now.
            out[path] = PrePickled(obj)
    stats: Dict[str, Any] = {
        "mode": mode,
        "copy_bytes": copy_bytes,
        "copy_s": time.monotonic() - begin,
        "n_arrays": len(paths),
    }
    # The copy is the stall the caller pays: attribute it like every other
    # pipeline phase.
    phase_stats.add("device_stage", stats["copy_s"], copy_bytes)
    if downgraded_from is not None:
        stats["downgraded_from"] = downgraded_from
        stats["downgrade_reason"] = downgrade_reason
    return out, stats


def _log_downgrade_event(from_mode: str, to_mode: str, reason: str) -> None:
    """Every staging downgrade is an event, not only a log line, so a fleet
    alerting on stall regressions sees it."""
    log_event(
        Event(
            name="async_take.staging_downgrade",
            metadata={"from_mode": from_mode, "to_mode": to_mode, "reason": reason},
        )
    )


def _is_prepare_time_safe(obj: Any) -> bool:
    """Leaves captured on the caller's thread at plan time: primitives
    inline into the manifest."""
    return PrimitiveEntry.supports(obj) and not isinstance(obj, np.generic)
