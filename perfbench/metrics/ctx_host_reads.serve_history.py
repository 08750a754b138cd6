"""ctx_host_reads.serve_history: the history encoder's reads of device
values by the host, a request: in the traced serving sub-window, the reads
made inside ``cse/ctx.encode`` (``aten::_local_scalar_dense`` and the CUDA
calls that block the host, ``perfbench/host_reads.py``) over the
occurrences of ``cse/ctx.encode``."""

from perfbench.metrics.deepseek_v2_work import encoder_record


def read(record):
    enc = encoder_record(record)
    reads = (enc or {}).get("host_reads")
    if not reads or not reads["occurrences"]:
        return None
    return reads["reads"] / reads["occurrences"]
