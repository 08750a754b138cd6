"""Operations and bytes of the Sepformer family at a cell's shapes.

The yardstick of the ``mfu.*`` and ``stack_roofline.*`` readers. Counts are
the model's mathematics, not an implementation's: every product counted
once as 2 x multiply-adds, the backward as twice the forward's products
(so a training step is 3 x a forward), no replay or recomputation. Each
product counts at the dense peak of its own type (NVIDIA H100 SXM data
sheet): a w8a8 stack's four projections in int8, its attention products
and everything else in the configuration's precision.
"""

from __future__ import annotations

PEAK = {"bf16": 989e12, "fp16": 989e12, "int8": 1979e12, "fp32": 67e12}
HBM_BYTES_S = 3.35e12
DTYPE_BYTES = {"bf16": 2, "fp16": 2, "fp32": 4, "int8": 1}


def frames(cfg: dict, T: int) -> int:
    return (T - cfg["enc_kernel"]) // cfg["enc_stride"] + 1


def chunks(cfg: dict, T: int) -> int:
    """S, the number of 50%-overlapped chunks of T samples' frames."""
    L, K = frames(cfg, T), cfg["chunk_size"]
    P = K // 2
    gap = K - (P + L % K) % K
    return (L + gap) // P + 1


def context_tokens(cfg: dict) -> int:
    return 1 if cfg["variant"] in ("contsep", "context") else 0


def stack_shapes(cfg: dict, B: int, T: int) -> dict[str, tuple[int, int]]:
    """(sequences, length) of the intra and inter stacks' input."""
    S, K, c = chunks(cfg, T), cfg["chunk_size"], context_tokens(cfg)
    return {"intra": (B * S, K + c), "inter": (B * K, S + c)}


def stack_products(cfg: dict, G: int, L: int, quant=None) -> dict[str, float]:
    """One stack's forward: per layer QKV, out-proj, FFN1, FFN2 and the two
    attention products QK^T and PV, by type."""
    D, F, n = cfg["d_model"], cfg["d_ffn"], cfg["num_tf_layers"]
    proj = n * 2.0 * G * L * (4 * D * D + 2 * D * F)
    attn = n * 4.0 * G * L * L * D
    prec = cfg["precision"]
    if quant == "w8a8":
        return {"int8": proj, prec: attn}
    return {prec: proj + attn}


def stack_bytes(cfg: dict, G: int, L: int, quant=None, train=False) -> float:
    """Inputs read once and outputs written once: x and y in the
    configuration's type, the stacked weights (int8 with fp32 scales under
    w8a8); training adds the incoming gradient, dx and the weight gradients."""
    D, F, n = cfg["d_model"], cfg["d_ffn"], cfg["num_tf_layers"]
    act = DTYPE_BYTES[cfg["precision"]] * G * L * D
    mats = n * (4 * D * D + 2 * D * F)
    weights = mats * (1 if quant == "w8a8" else DTYPE_BYTES[cfg["precision"]]) + 4 * n * 10 * D
    return (4 * act + 2 * weights) if train else (2 * act + weights)


def ideal_seconds(products: dict[str, float]) -> float:
    return sum(v / PEAK[k] for k, v in products.items())


def stack_bound_seconds(cfg: dict, G: int, L: int, quant=None, train=False) -> float:
    """The least time of one stack call (training: forward and backward):
    operations at their peaks or bytes at 3.35 TB/s, the larger."""
    ops = {k: (3 if train else 1) * v for k, v in stack_products(cfg, G, L, quant).items()}
    return max(ideal_seconds(ops), stack_bytes(cfg, G, L, quant, train) / HBM_BYTES_S)


def forward_products(cfg: dict, B: int, T: int, quant=None) -> dict[str, float]:
    """The whole separator's forward on B mixtures of T samples, by type."""
    prec = cfg["precision"]
    N, D, k, spk = cfg["enc_channels"], cfg["d_model"], cfg["enc_kernel"], cfg["num_spks"]
    L, S, K, c = frames(cfg, T), chunks(cfg, T), cfg["chunk_size"], context_tokens(cfg)
    streams = 1 if cfg["variant"] == "context" else spk
    glue = 2.0 * B * L * N * k  # encoder
    glue += 2.0 * B * L * N * D  # 1x1 after the GroupNorm
    glue += cfg["num_dp_layers"] * 2 * 2.0 * B * c * cfg["llm_dim"] * D  # context mappers
    glue += 2.0 * B * S * K * D * D * spk  # mask head's 1x1 to the streams
    glue += 2 * 2.0 * B * spk * L * D * D + 2.0 * B * spk * L * D * N  # output, gate, end 1x1
    glue += streams * 2.0 * B * L * N * k  # decoder
    out = {prec: glue}
    for _ in range(cfg["num_dp_layers"]):
        for G, Ls in stack_shapes(cfg, B, T).values():
            for t, v in stack_products(cfg, G, Ls, quant).items():
                out[t] = out.get(t, 0.0) + v
    return out


def train_step_seconds(cfg: dict, B: int, T: int) -> float:
    """The least time of a training step: 3 x the forward at its peaks."""
    return 3 * ideal_seconds(forward_products(cfg, B, T))
