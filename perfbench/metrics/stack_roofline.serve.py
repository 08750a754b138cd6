"""stack_roofline.serve: the serving stack entry (bf16 or w8a8) timed alone
at every request length's intra and inter shapes, against its bound: its
operations at their types' peaks or its bytes at 3.35 TB/s, the larger,
summed over the shapes (%)."""

from perfbench.metrics.sepformer_work import stack_bound_seconds


def read(record):
    stack = record.get("stack")
    if record.get("kind") != "serve" or not stack:
        return None
    cfg = record["config"]
    bound = sum(stack_bound_seconds(cfg, c["G"], c["L"], stack["quant"], False) for c in stack["calls"])
    return 100.0 * bound / (sum(c["ms"] for c in stack["calls"]) / 1e3)
