"""Operations and bytes of the DeepSeek-V2 history encoder at a request's shapes.

The yardstick of the ``*.serve_history`` readers. Counts are the model's
mathematics on the real tokens, not an implementation's: padding is not
work, attention counts the causal pairs of each history alone (n(n+1)/2 for
n tokens), each routed token counts its ``num_experts_per_tok`` experts and
no more. Every product is 2 x multiply-adds at the dense peak of its type
(``sepformer_work.PEAK``): bf16, the router's logits fp32. Bytes count each
weight read once a call (a call encodes a request's histories together) and
the layer's input and output once.

``cfg`` is the cell's configuration: the checkout's ``config.json`` keys.
"""

from __future__ import annotations

from perfbench.metrics.sepformer_work import DTYPE_BYTES, HBM_BYTES_S, ideal_seconds
from perfbench.spans import args_of


def _mla_weights(cfg: dict) -> int:
    D, H, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    return D * H * (dn + dr) + D * (r + dr) + r * H * (dn + dv) + H * dv * D


def mla_products(cfg: dict, lengths: list[int]) -> dict[str, float]:
    """One latent-attention layer over histories of ``lengths`` tokens."""
    H, dn, dr, dv = cfg["num_attention_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    n = sum(lengths)
    pairs = sum(m * (m + 1) / 2 for m in lengths)
    return {"bf16": 2.0 * n * _mla_weights(cfg) + 2.0 * pairs * H * (dn + dr + dv)}


def mla_bytes(cfg: dict, lengths: list[int]) -> float:
    return 2.0 * _mla_weights(cfg) + 2 * 2.0 * sum(lengths) * cfg["hidden_size"]


def moe_products(cfg: dict, lengths: list[int]) -> dict[str, float]:
    """One mixture layer: the fp32 router, each token's routed experts and the shared experts."""
    D, Ie, E, k = cfg["hidden_size"], cfg["moe_intermediate_size"], cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    n = sum(lengths)
    return {"fp32": 2.0 * n * D * E, "bf16": 2.0 * n * (k + cfg["n_shared_experts"]) * 3 * D * Ie}


def moe_bytes(cfg: dict, lengths: list[int]) -> float:
    D, Ie, E = cfg["hidden_size"], cfg["moe_intermediate_size"], cfg["n_routed_experts"]
    weights = DTYPE_BYTES["bf16"] * 3 * D * Ie * (E + cfg["n_shared_experts"]) + DTYPE_BYTES["fp32"] * E * D
    return weights + 2 * 2.0 * sum(lengths) * D


def dense_products(cfg: dict, lengths: list[int]) -> dict[str, float]:
    return {"bf16": 2.0 * sum(lengths) * 3 * cfg["hidden_size"] * cfg["intermediate_size"]}


def moe_layers(cfg: dict) -> int:
    return sum(1 for i in range(cfg["num_hidden_layers"])
               if cfg["n_routed_experts"] and i >= cfg["first_k_dense_replace"] and i % cfg["moe_layer_freq"] == 0)


def encoder_products(cfg: dict, lengths: list[int]) -> dict[str, float]:
    """The whole prefill of one request's histories, by type."""
    n_moe = moe_layers(cfg)
    out: dict[str, float] = {}
    for part, times in ((mla_products(cfg, lengths), cfg["num_hidden_layers"]),
                        (moe_products(cfg, lengths), n_moe),
                        (dense_products(cfg, lengths), cfg["num_hidden_layers"] - n_moe)):
        for t, v in part.items():
            out[t] = out.get(t, 0.0) + times * v
    return out


def bound_seconds(products: dict[str, float], nbytes: float) -> float:
    """The least time: operations at their peaks or bytes at HBM speed, the larger."""
    return max(ideal_seconds(products), nbytes / HBM_BYTES_S)


def mla_bound_seconds(cfg: dict, lengths: list[int]) -> float:
    return bound_seconds(mla_products(cfg, lengths), mla_bytes(cfg, lengths))


def moe_bound_seconds(cfg: dict, lengths: list[int]) -> float:
    return bound_seconds(moe_products(cfg, lengths), moe_bytes(cfg, lengths))


# ---------------------------------------------------------------- the traced run's record


def encoder_record(record: dict) -> dict | None:
    """The traced serving record's encoder rows, None where the run had none."""
    if record.get("kind") != "serve" or not record.get("encoder") or not record.get("spans"):
        return None
    return record["encoder"]


def by_width(spans: dict, prefix: str, counted: str) -> tuple[dict[int, int], float]:
    """Of the span table's rows ``prefix...[B=..,T=..]``: whole occurrences
    of the row ``counted`` by width T, and the device seconds of them all."""
    counts, device_s = {}, 0.0
    for name, row in spans.items():
        if not name.startswith(prefix):
            continue
        device_s += row["device_s"]
        if name.split("[")[0] == counted:
            T = args_of(name)["T"]
            counts[T] = counts.get(T, 0) + row["count"]
    return counts, device_s


def roofline(record: dict, prefix: str, counted: str, bound) -> float | None:
    """Bound seconds of the occurrences counted over the device seconds of
    the rows under ``prefix`` (%). A width's occurrences are costed at the
    mean bound of the requests launched at that width in the sub-window."""
    enc = encoder_record(record)
    if enc is None:
        return None
    counts, device_s = by_width(record["spans"], prefix, counted)
    sent = {}
    for W, lengths in enc["submitted"]:
        sent.setdefault(W, []).append(bound(record["config"], lengths))
    ideal = sum(c * sum(sent[W]) / len(sent[W]) for W, c in counts.items() if W in sent)
    if not device_s or not ideal:
        return None
    return 100.0 * ideal / device_s
