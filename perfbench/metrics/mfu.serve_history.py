"""mfu.serve_history: the operations of the requests the device ran in the
traced serving sub-window, the history encoder's on the real tokens
(``deepseek_v2_work``) and the separator's forward (``sepformer_work``),
each product at its type's dense peak, over the sub-window's time (%)."""

from perfbench.metrics.deepseek_v2_work import encoder_products, encoder_record
from perfbench.metrics.sepformer_work import forward_products, ideal_seconds


def read(record):
    if encoder_record(record) is None:
        return None
    cfg, sub = record["config"], record["sub_window"]
    ideal = sum(ideal_seconds(forward_products(cfg, record["batch"], T, record["quant"])) for T in sub["samples"])
    ideal += sum(ideal_seconds(encoder_products(cfg, lengths)) for lengths in sub["histories"])
    return 100.0 * ideal / sub["elapsed_s"]
