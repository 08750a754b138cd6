"""Tracing on demand with ``torch.profiler`` (the reference has no profiler).

Usage:
    with trace_if("runs/trace", step, start=100, stop=105):
        run_step(...)
or set CSE_TPU_PROFILE=/path to capture steps 10-20 of any training run; the
trace is written to ``<logdir>/trace_steps_<start>_<stop>.json`` (Chrome
trace format). With ``summary`` (a dict) the window's device activity
(:func:`device_activity`) is written into it when the window closes, with or
without a ``logdir``.
"""

from __future__ import annotations

import contextlib
import os

_ACTIVE = {}

# the loop's host ranges, by which device_activity splits the device time
RANGE_PREFIX = "cse/"


def device_activity(prof) -> dict:
    """What the device did during a finished ``torch.profiler`` profile:
    ``wall_ms`` from its first activity's start to its last one's end,
    ``kernel_ms`` the activities' summed time, ``busy_share`` their ratio,
    ``longest_idle_gap_ms`` between two activities, and ``range_ms``: for each
    ``record_function`` range named ``cse/...`` the device time of the work
    launched inside it on the range's own thread (a backward pass launches from
    autograd's thread and is not counted), one entry per occurrence. Without
    device events only ``range_ms`` is there."""
    from torch.autograd import DeviceType

    spans, ranges = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation:  # the ranges' device-side mirrors are not work
                spans.append((e.time_range.start, e.time_range.end))
        elif e.name.startswith(RANGE_PREFIX):
            ranges.setdefault(e.name[len(RANGE_PREFIX):], []).append(e.device_time_total / 1e3)
    if not spans:
        return {"range_ms": ranges}
    spans.sort()
    busy = sum(b - a for a, b in spans)
    gap, end = 0.0, spans[0][1]
    for a, b in spans[1:]:
        gap, end = max(gap, a - end), max(end, b)
    wall = end - spans[0][0]
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
