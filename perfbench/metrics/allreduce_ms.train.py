"""allreduce_ms.train: the data-parallel step's gradient all-reduce alone,
on a buffer of its size over the data ranks, CUDA events (ms)."""


def read(record):
    return record.get("allreduce_ms") if record.get("kind") == "train" else None
