"""The port's benchmark: a data-driven harness over ``cse_tpu_torch`` (see ``run.py``)."""
