"""stack_roofline.train: the training stack entry (forward and backward)
timed alone at the step's intra and inter shapes, against its bound: the
stack's operations (3 x its forward's products) at their peaks or its
bytes at 3.35 TB/s, the larger, summed over the shapes (%)."""

from perfbench.metrics.sepformer_work import stack_bound_seconds


def read(record):
    stack = record.get("stack")
    if record.get("kind") != "train" or not stack:
        return None
    cfg = record["config"]
    bound = sum(stack_bound_seconds(cfg, c["G"], c["L"], stack["quant"], True) for c in stack["calls"])
    return 100.0 * bound / (sum(c["ms"] for c in stack["calls"]) / 1e3)
