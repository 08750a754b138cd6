"""The traced sub-window's span table: where the program's ``cse/`` spans
spent the host's time, the device's work and the device's idle time.

The program opens a ``record_function`` range named ``cse/<name>`` (with
``[G=..,L=..]`` appended where it has arguments) around each piece of its
work while a profiler runs. :func:`reduce_spans` gives, for each such name,

* ``count``: occurrences whose host interval lies wholly inside the
  sub-window, and whose launched work had all run by its end;
* ``host_s``: their summed host time;
* ``device_s``: the device work they launched, as a union of intervals
  clipped to the sub-window. Each device interval goes to the innermost
  span, on any thread, open at its launch; the launch is the host event
  that issued it, found by correlation id (the runtime call with the
  interval's id, else the operator its ``linked_correlation_id`` names), so
  the backward's kernels, launched from autograd's thread, reach the span
  open there. Where two rows' work overlaps, the time goes to the work that
  reached it first, so that the rows add up to the union;
* ``idle_s``: the sub-window's device-idle time, apportioned at each instant
  to the innermost span open on the host then;

and three rows for what belongs to no span: ``(outside)`` (no span open),
``(unlinked)`` (work whose launch was not recorded inside the sub-window, as
work queued before it began) and ``(cut)`` (occurrences that cross an edge
of the sub-window: their host interval does, or it ends after the launch of
work that was still unfinished at the sub-window's end; ``count`` and
``host_s`` of this row are those occurrences'). Over all rows ``device_s``
sums to the busy time of ``trace.reduce_events`` and ``idle_s`` to the rest
of the sub-window.

This module reads the profiler's events alone and imports nothing of the
program: it runs against any version of it (one without spans gives the
three rows alone).

The harness does not call it yet. A per-layer reader sees only a traced
run's record, and ``trace.SubWindow.stop`` keeps of the profiler's events
only what ``trace.reduce_events`` gives; a reader of this table needs it
under a key of that summary (``spans=reduce_spans(events, window_us)``).
"""

from __future__ import annotations

import bisect
import re

PREFIX = "cse/"
OUTSIDE, UNLINKED, CUT = "(outside)", "(unlinked)", "(cut)"
_ARGS = re.compile(r"\[(.*)\]$")


def args_of(name: str) -> dict[str, int]:
    """The arguments a row's name carries: ``"cse/x[G=4,L=9]"`` -> ``{"G": 4, "L": 9}``."""
    m = _ARGS.search(name)
    if not m:
        return {}
    return {k: int(v) for k, v in (kv.split("=") for kv in m.group(1).split(","))}


def _is_launch_call(e) -> bool:
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind in ("cuda_runtime", "cuda_driver")
    return e.name.startswith("cu")


class _Spans:
    """The occurrences of ``cse/`` ranges, for "innermost open at t" (the
    one that started last among those containing t, on any thread)."""

    def __init__(self, occ):
        self.occ = sorted(occ, key=lambda o: (o[0], -o[1]))
        self.starts = [o[0] for o in self.occ]
        self.edges = sorted({t for o in self.occ for t in o[:2]})

    def at(self, t):
        for i in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            if self.occ[i][1] >= t:
                return i
        return None


def reduce_spans(events, window_us: float) -> dict[str, dict]:
    """The span table (see the module docstring) of profiler events whose
    times count from the profile's start, over the sub-window ``[0,
    window_us]``.

    The sub-window's host clock starts a little after the profile's (0.4-1
    ms on a CPU): its end on the profile's clock is ``window_us`` plus the
    start of the first host operation. Device time and idle time are
    clipped to ``[0, window_us]``, as ``trace.reduce_events`` clips them;
    whether an occurrence lies inside, and whether work was unfinished, is
    judged against that later end."""
    from torch.autograd import DeviceType

    W = window_us
    occ, calls, ops, dev, first = [], {}, {}, [], None
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation:
                dev.append((e.id, getattr(e, "linked_correlation_id", 0), s, t))
            continue
        if e.name.startswith(PREFIX):
            occ.append((s, t, e.name))
        if _is_launch_call(e):
            calls[e.id] = s
        else:
            ops.setdefault(e.id, s)
            first = s if first is None else min(first, s)
    end = W + max(first or 0.0, 0.0)
    spans = _Spans(occ)

    work = []  # (start, end, launch inside the sub-window or None)
    for cid, linked, s, t in dev:
        launch = calls.get(cid)
        if launch is None and linked:  # older torch keeps no linked id on its events
            launch = ops.get(linked)
        if launch is not None and not 0.0 <= launch <= end:
            launch = None
        work.append((s, t, launch))
    # work still running at the sub-window's end: every occurrence that ends after its launch is cut
    late = min((launch for s, t, launch in work if launch is not None and t > end), default=None)
    whole = [0.0 <= s and e <= end and (late is None or e <= late) for s, e, _ in spans.occ]

    def row(i):
        if i is None:
            return OUTSIDE
        return spans.occ[i][2] if whole[i] else CUT

    table = {}

    def add(name, key, v):
        r = table.setdefault(name, {"count": 0, "host_s": 0.0, "device_s": 0.0, "idle_s": 0.0})
        r[key] += v

    for name in (OUTSIDE, UNLINKED, CUT):
        add(name, "count", 0)
    for i, (s, e, name) in enumerate(spans.occ):
        if s < end:
            add(row(i), "count", 1)
            add(row(i), "host_s", (min(e, end) - s) / 1e6)

    # device: each clipped interval's part beyond the covered frontier, to its launcher's row
    frontier, busy = 0.0, []
    for s, t, launch in sorted(((max(s, 0.0), min(t, W), launch) for s, t, launch in work), key=lambda w: w[:2]):
        if t <= s:
            continue
        if t > frontier:
            a = max(s, frontier)
            add(UNLINKED if launch is None else row(spans.at(launch)), "device_s", (t - a) / 1e6)
            if busy and a <= busy[-1][1]:
                busy[-1][1] = t
            else:
                busy.append([a, t])
            frontier = t

    # idle: each gap, cut at every span edge inside it, to the innermost span open there
    gaps, prev = [], 0.0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if W > prev:
        gaps.append((prev, W))
    for a, b in gaps:
        cuts = spans.edges[bisect.bisect_right(spans.edges, a):bisect.bisect_left(spans.edges, b)]
        points = [a, *cuts, b]
        for p, q in zip(points, points[1:]):
            add(row(spans.at(0.5 * (p + q))), "idle_s", (q - p) / 1e6)
    return table
