"""Test-set evaluation: the evaluator, its float64 host metrics and PESQ.

Port of ``cse_tpu/eval`` (``evaluator``, ``metrics``, ``host_metrics``,
``pesq``). Import the modules themselves: this package file imports nothing,
so the metric workers, which import ``host_metrics``, load no torch.
"""
