"""The traced run's profile: a short steady sub-window under ``torch.profiler``.

:class:`SubWindow` profiles the work between :meth:`start` and
:meth:`stop` (both wait for the device) and reduces the trace to what the
result line carries: the seconds in which some operation ran on the device
(the union of the device intervals, so that overlapping streams count
once), the sub-window's length on the host clock, the device operations that
took most time, and the longest gaps between device work, each named by the
host operation that spans most of it. Nothing is written to disk.

The arithmetic of the busy share is that of the port's
``utils/profiling.py::device_activity``, copied, with the sum of durations
replaced by the union of intervals.
"""

from __future__ import annotations

import time

import torch

TOP = 10  # entries in each list of the breakdown
NAME_CHARS = 120


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _merge(spans):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _label(gap, host):
    """The host operation that covers at least half of the gap with the
    shortest duration (the innermost), else the one that overlaps it most."""
    a, b = gap
    best, best_cover = None, None
    for name, s, e in host:
        over = min(b, e) - max(a, s)
        if over <= 0:
            continue
        if over >= 0.5 * (b - a) and (best_cover is None or (e - s) < best_cover[1]):
            best_cover = (name, e - s)
        if best is None or over > best[1]:
            best = (name, over)
    if best_cover is not None:
        return best_cover[0]
    return best[0] if best else "(no host operation)"


def reduce_events(events, window_us: float) -> dict:
    """``busy_s``, ``device_ops`` and ``idle_gaps`` from profiler events,
    clipped to the sub-window (event times count from the profile's start)."""
    from torch.autograd import DeviceType

    dev, host, by_name = [], [], {}
    for e in events:
        s, t = max(e.time_range.start, 0.0), min(e.time_range.end, window_us)
        if t <= s:
            continue
        if e.device_type == DeviceType.CUDA:
            if e.is_user_annotation:
                continue
            dev.append((s, t))
            by_name[e.name] = by_name.get(e.name, 0.0) + (t - s)
        else:
            host.append((e.name, s, t))
    merged = _merge(dev)
    busy_us = sum(b - a for a, b in merged)
    gaps = sorted(((merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)),
                  key=lambda g: g[0] - g[1])[:TOP]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_us / 1e6,
            "device_ops": [[n[:NAME_CHARS], us / 1e6] for n, us in ops],
            "idle_gaps": [[_label(g, host)[:NAME_CHARS], (g[1] - g[0]) / 1e6] for g in gaps]}


class SubWindow:
    """Profile from :meth:`start` to :meth:`stop`; :attr:`summary` after."""

    def __init__(self, device):
        self.device = device
        self.summary = None
        self._prof = None

    def start(self, sync: bool = True):
        """Begin; ``sync`` first waits for the device (a loop with work in
        flight passes False, so that the queue stays as it is)."""
        from torch.profiler import ProfilerActivity, profile

        if sync:
            _sync(self.device)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self, sync: bool = True):
        if sync:
            _sync(self.device)
        window = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        self.summary = dict(reduce_events(self._prof.events(), 1e6 * window), window_s=window)
        self._prof = None
        return self.summary
