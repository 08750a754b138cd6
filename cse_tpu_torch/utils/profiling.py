"""Spans and tracing on demand with ``torch.profiler`` (the reference has no profiler).

Usage:
    with span("model.encode"):        # a "cse/model.encode" range while a profiler runs
        w = model.encode(mix)
    with trace_if("runs/trace", step, start=100, stop=105):
        run_step(...)
or set CSE_TPU_PROFILE=/path to capture steps 10-20 of any training run; the
trace is written to ``<logdir>/trace_steps_<start>_<stop>.json`` (Chrome
trace format), with the spans beside the device work on the profiler's
clock. With ``summary`` (a dict) the window's device activity
(:func:`device_activity`) is written into it when the window closes, with or
without a ``logdir``. :class:`DeviceCounters` keeps counts where they are
made, on the device, for a reader after the work.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.autograd import DeviceType, profiler as _profiler

_ACTIVE = {}

# the program's host ranges, by which device_activity splits the device time
RANGE_PREFIX = "cse/"
_NO_SPAN = contextlib.nullcontext()


def span(name: str, args: dict | None = None):
    """A ``record_function`` range named ``"cse/" + name`` while a profiler
    runs, else one shared no-op context (one attribute read: no allocation,
    no dispatcher call, no clock read). ``args`` (e.g. ``{"G": 2016, "L":
    251}``) are appended to the name as ``[G=2016,L=251]``: the profiler's
    events do not carry ``record_function``'s own argument string."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    if args:
        name += "[" + ",".join(f"{k}={v}" for k, v in args.items()) + "]"
    return _profiler.record_function(RANGE_PREFIX + name)


class DeviceCounters:
    """Named counts: device tensors summed in place where the work makes
    them (no host read on the path that counts). ``read`` copies them to
    the host, after the work they count."""

    def __init__(self):
        self._dev: dict = {}

    def add(self, name: str, value):
        """Add a device tensor (any integer shape) to the count ``name``.
        The count is an ordinary tensor even when made under
        ``inference_mode``, so that calls inside and outside it both add."""
        t = self._dev.get(name)
        if t is None:
            with torch.inference_mode(False):
                self._dev[name] = value.detach().to(dtype=torch.int64).clone()
        else:
            t.add_(value)

    def read(self) -> dict:
        """Every count as Python numbers (ints, or lists for vectors)."""
        return {k: v.tolist() for k, v in self._dev.items()}


def _is_launch_call(e) -> bool:
    """A host event of the CUDA runtime or driver (``cudaLaunchKernel``,
    ``cudaMemcpyAsync``, ...): its id is the correlation id of the device
    work it issued."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind in ("cuda_runtime", "cuda_driver")
    return e.name.startswith("cu")


def _launches(events) -> list[tuple[float | None, float, float]]:
    """``(launch, start, end)`` of each device activity (µs on the profile's
    clock): ``launch`` is the start of the host event that issued it, found
    by correlation id (the runtime call with the activity's id, else the
    operator its ``linked_correlation_id`` names), None when neither was
    recorded. The ranges' device-side mirrors are not work and are left out."""
    calls, ops, dev = {}, {}, []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation:
                dev.append(e)
        elif _is_launch_call(e):
            calls[e.id] = e.time_range.start
        else:
            ops.setdefault(e.id, e.time_range.start)
    out = []
    for e in dev:
        t = calls.get(e.id)
        linked = getattr(e, "linked_correlation_id", 0)  # older torch keeps none on its events
        if t is None and linked:
            t = ops.get(linked)
        out.append((t, e.time_range.start, e.time_range.end))
    return out


def _union(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def device_activity(prof) -> dict:
    """What the device did during a finished ``torch.profiler`` profile:
    ``wall_ms`` from its first activity's start to its last one's end,
    ``kernel_ms`` the time in which some activity ran (the union of their
    intervals, so overlapping streams count once), ``busy_share`` their
    ratio, ``longest_idle_gap_ms`` between two activities, and ``range_ms``:
    for each ``record_function`` range named ``cse/...`` (its name after the
    prefix), one entry per occurrence, the device time (union) of the work
    launched while it was open, on any thread (autograd's included), matched
    to its launch by correlation id (:func:`_launches`); nested ranges count
    in each. Without device events only ``range_ms`` is there."""
    events = list(prof.events())
    work = _launches(events)
    ranges = {}
    for e in events:
        if e.name.startswith(RANGE_PREFIX) and e.device_type != DeviceType.CUDA:
            a, b = e.time_range.start, e.time_range.end
            inside = [(s, t) for launch, s, t in work if launch is not None and a <= launch <= b]
            ranges.setdefault(e.name[len(RANGE_PREFIX):], []).append(_union(inside) / 1e3)
    if not work:
        return {"range_ms": ranges}
    spans = sorted((s, t) for _, s, t in work)
    gap, end = 0.0, spans[0][1]
    for a, b in spans[1:]:
        gap, end = max(gap, a - end), max(end, b)
    wall = end - spans[0][0]
    busy = _union(spans)
    return {"wall_ms": wall / 1e3, "kernel_ms": busy / 1e3, "busy_share": busy / wall,
            "longest_idle_gap_ms": gap / 1e3, "range_ms": ranges}


@contextlib.contextmanager
def trace_if(logdir: str | None, step: int, start: int = 10, stop: int = 20, summary: dict | None = None):
    """Capture a torch.profiler trace for steps in [start, stop)."""
    on = bool(logdir) or summary is not None
    if on and step == start and "prof" not in _ACTIVE:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        _ACTIVE["prof"] = profile(activities=acts)
        _ACTIVE["prof"].__enter__()
    try:
        yield
    finally:
        if on and step == stop - 1 and "prof" in _ACTIVE:
            import torch

            prof = _ACTIVE.pop("prof")
            if torch.cuda.is_available():
                torch.cuda.synchronize()  # the window ends when its last step's work has run
            prof.__exit__(None, None, None)
            if summary is not None:
                summary.update(device_activity(prof))
            if logdir:
                os.makedirs(logdir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(logdir, f"trace_steps_{start}_{stop}.json"))


def profile_dir_from_env() -> str | None:
    return os.environ.get("CSE_TPU_PROFILE") or None
