"""The host's reads of device values inside a span, from a profile's events.

A read is an operation that waits for the device to hand a value to the
host: ``aten::_local_scalar_dense`` (``.item()``, ``int(t)``, a Python
``if`` on a tensor) or a CUDA call that blocks the host
(:data:`BLOCKING`: a stream, device or event synchronisation, a blocking
``cudaMemcpy``). Where they nest (``.item()`` on the card is a
``_local_scalar_dense`` around a copy and a stream synchronisation) they
count once. A sizing read inside an operator counts as well: ``bincount``
or ``nonzero`` on the card synchronise the stream under their own name.

:func:`count_reads` counts the reads made inside the occurrences of one
span (``cse/ctx.encode``: the history encoder's prefill), on the thread
that opened it, and the occurrences. It reads the profiler's events alone
and imports nothing of the program.
"""

from __future__ import annotations

SCALAR = "aten::_local_scalar_dense"
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


def is_read(name: str) -> bool:
    return name == SCALAR or name in BLOCKING


def count_reads(events, span: str) -> dict[str, int]:
    """``{"reads": n, "occurrences": m}``: the outermost reads that lie
    inside an occurrence of ``span`` on its thread, and the occurrences of
    ``span`` (host events with that exact name) in ``events``."""
    from torch.autograd import DeviceType

    occ, reads = [], []
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        s, t = e.time_range.start, e.time_range.end
        if e.name == span:
            occ.append((e.thread, s, t))
        elif is_read(e.name):
            reads.append((e.thread, s, t))
    outer, last = [], {}
    for thread, s, t in sorted(reads, key=lambda r: (r[0], r[1], -r[2])):
        if t <= last.get(thread, float("-inf")):
            continue  # inside a read already counted
        last[thread] = t
        outer.append((thread, s, t))
    n = sum(any(th == thread and a <= s and t <= b for th, a, b in occ) for thread, s, t in outer)
    return {"reads": n, "occurrences": len(occ)}
