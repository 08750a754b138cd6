"""What the benchmark takes from the program under test, ``cse_tpu_torch``.

The port is imported here and in the traffic drivers, inside functions, so
that the registry, the readers and the reference load without it. The
model is built on the ``meta`` device and given the benchmark's weights
(:mod:`perfbench.weights`) on the run's device, so nothing of the model is
made on the host.
"""

from __future__ import annotations

import torch

MODEL_KEYS = ("variant", "num_spks", "ce", "enc_channels", "enc_kernel", "enc_stride", "d_model", "nhead", "d_ffn",
              "num_tf_layers", "num_dp_layers", "chunk_size", "llm_dim", "pe_max_len")
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def sepformer_config(cfg: dict):
    from cse_tpu_torch.models import SepformerConfig

    return SepformerConfig(**{k: cfg[k] for k in MODEL_KEYS}, compute_dtype=DTYPES[cfg["precision"]])


def build_model(cfg: dict, weights: dict, device):
    """The port's ``Sepformer`` holding ``weights`` on ``device``."""
    from cse_tpu_torch.models import Sepformer

    with torch.device("meta"):
        model = Sepformer(sepformer_config(cfg))
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model


def launch_counts() -> dict[str, dict[str, int]]:
    """Every kernel wrapper's launches so far, by module (the program's counters)."""
    from cse_tpu_torch.ops import attention, fused_stack_w8a8, fused_train

    mods = {"fused_train": fused_train, "fused_stack_w8a8": fused_stack_w8a8, "attention": attention}
    return {name: {k: v for k, v in m.launch_counts().items() if v} for name, m in mods.items()}
