"""mfu.serve: the forward's operations of the requests the device ran in
the traced serving sub-window (each product at its type's dense peak) over
the sub-window's time (%)."""

from perfbench.metrics.sepformer_work import forward_products, ideal_seconds


def read(record):
    if record.get("kind") != "serve":
        return None
    sub = record["sub_window"]
    ideal = sum(ideal_seconds(forward_products(record["config"], record["batch"], T, record["quant"]))
                for T in sub["samples"])
    return 100.0 * ideal / sub["elapsed_s"]
