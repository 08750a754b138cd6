"""mfu.train: the model's operations in the traced training sub-window
(3 x the forward a step, each product at its type's dense peak) over the
sub-window's time, a chip's share (%)."""

from perfbench.metrics.sepformer_work import train_step_seconds


def read(record):
    if record.get("kind") != "train":
        return None
    sub = record["sub_window"]
    ideal = train_step_seconds(record["config"], record["batch"], record["samples"])
    return 100.0 * ideal * sub["steps"] / sub["elapsed_s"]
