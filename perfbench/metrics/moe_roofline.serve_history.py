"""moe_roofline.serve_history: the history encoder's mixture-of-experts
layers in the traced serving sub-window against their bound: each whole
``cse/ctx.moe.experts`` occurrence costs one layer's operations on its
request's real tokens at their peaks or its weights and activations at
3.35 TB/s, the larger (``deepseek_v2_work``), over the device seconds under
``cse/ctx.moe.*`` (%)."""

from perfbench.metrics.deepseek_v2_work import moe_bound_seconds, roofline


def read(record):
    return roofline(record, "cse/ctx.moe.", "cse/ctx.moe.experts", moe_bound_seconds)
