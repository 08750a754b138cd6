"""mla_roofline.serve_history: the history encoder's latent attention in the
traced serving sub-window against its bound: each whole ``cse/ctx.mla``
occurrence (RMSNorm, projections, causal attention) costs one layer's
operations on its request's real tokens, causal pairs only, at the bf16
peak or its weights and activations at 3.35 TB/s, the larger
(``deepseek_v2_work``), over the device seconds under ``cse/ctx.mla`` (%)."""

from perfbench.metrics.deepseek_v2_work import mla_bound_seconds, roofline


def read(record):
    return roofline(record, "cse/ctx.mla", "cse/ctx.mla", mla_bound_seconds)
