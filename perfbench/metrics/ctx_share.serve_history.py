"""ctx_share.serve_history: the device seconds of the traced serving
sub-window under the history encoder's spans (``cse/ctx.*``) over all its
busy seconds (%). Lower means the separator's share grows."""

from perfbench.metrics.deepseek_v2_work import encoder_record


def read(record):
    if encoder_record(record) is None:
        return None
    rows = record["spans"]
    busy = sum(r["device_s"] for r in rows.values())
    return 100.0 * sum(r["device_s"] for n, r in rows.items() if n.startswith("cse/ctx.")) / busy if busy else None
