"""Context encoders: frozen wrappers producing the 4096-d cue vectors.

Port of ``cse_tpu/models/context_encoder.py``. The reference conditions the
separator on ``LlamaModel(...).last_hidden_state[:, -ctx_length:]`` of the
tokenized dialog history (``train_ContSep.py:379-380``,
``train_ContExt.py:362``). The encoder is an interchangeable callable
``(ids [B, T], mask [B, T]) -> [B, ctx_length, dim]``:

* :class:`cse_tpu_torch.models.llama.LlamaContextEncoder`, the real one,
  which :func:`build_context_encoder` returns for a directory that holds
  Llama weights (``config.json`` + ``*.safetensors``);
* :class:`cse_tpu_torch.models.deepseek_v2.DeepseekV2ContextEncoder`, which
  it returns instead where that ``config.json`` says ``"model_type":
  "deepseek_v2"``;
* :class:`HashProjectionEncoder` is the deterministic, parameter-free
  stand-in: fixed random-feature token embeddings, masked causal-mean
  readout. It exercises the identical conditioning plumbing (shapes, dtypes)
  but is NOT compatible with released checkpoints; construction warns loudly.

The stand-in's two tables (``w``, ``p``, each ``[dim]``) are buffers. By
default they are drawn from a ``torch.Generator`` seeded with ``seed``; the
JAX package draws its own from ``jax.random``, and
``compat.jax_params.hash_encoder_tables`` carries those across, so that both
packages compute the same function on the same tables.
"""

from __future__ import annotations

import json
import os
import sys

import torch


class HashProjectionEncoder(torch.nn.Module):
    """Deterministic random-feature embedding of token ids (llm stand-in)."""

    is_stub = True

    def __init__(self, dim: int = 4096, ctx_length: int = 1, seed: int = 0,
                 tables: tuple[torch.Tensor, torch.Tensor] | None = None):
        super().__init__()
        self.dim = dim
        self.ctx_length = ctx_length
        self.seed = seed
        if tables is None:
            gen = torch.Generator().manual_seed(seed)
            w = torch.randn(dim, generator=gen) * 0.02
            p = torch.rand(dim, generator=gen) * 6.283
        else:
            w, p = (torch.as_tensor(t, dtype=torch.float32).reshape(dim) for t in tables)
        self.register_buffer("w", w)
        self.register_buffer("p", p)
        print(
            "[cse_tpu_torch] WARNING: using HashProjectionEncoder — dialog-history "
            "conditioning is a deterministic stand-in, NOT Llama-3; released "
            "checkpoints will not be meaningful.",
            file=sys.stderr,
        )

    @torch.no_grad()
    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return _hash_encode(ids, mask, self.w, self.p, self.ctx_length)

    def pure(self):
        """(apply(params, ids, mask), params), the signature the train and
        eval steps thread; params are the two tables."""
        ctx_length = self.ctx_length

        def apply(params, ids, mask):
            w, p = params
            return _hash_encode(ids, mask, w, p, ctx_length)

        return apply, (self.w, self.p)


def _hash_encode(ids, mask, w, p, ctx_length):
    ids = ids.to(w.device)
    mask = mask.to(w.device)
    emb = torch.sin(ids[:, :, None].float() * w + p)  # [B, T, dim]
    emb = emb * mask[:, :, None].float()
    # cumulative context summary at each position (causal mean), then read the
    # last ctx_length positions (left padding puts real tokens at the right)
    csum = torch.cumsum(emb, dim=1)
    cnt = torch.cumsum(mask, dim=1).clamp_min(1)[:, :, None].float()
    return (csum / cnt)[:, -ctx_length:, :]


def llama_weights_available(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, "config.json"))


def checkout_model_type(path: str) -> str | None:
    """``model_type`` of ``path/config.json`` (None when it names none)."""
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f).get("model_type")


def build_context_encoder(
    llama_path: str,
    ctx_length: int = 1,
    dim: int = 4096,
    auth_token: str | None = None,
    force_stub: bool = False,
    quant: str | None = None,
    device=None,
    mesh=None,
):
    """Return the encoder for the checkout ``llama_path``: DeepSeek-V2 where
    its ``config.json`` has ``model_type`` ``deepseek_v2`` (bf16 on
    ``device``, whole on each rank: no ``quant``, no model axis), the Llama encoder for
    any other checkout (bf16, ``quant`` None, "int8" or "w8a8", on
    ``device``: the card unless ``device="cpu"``; tensor-parallel over
    ``mesh``'s model axis, ``models/llama.py::llama_shardings``), else the
    stub."""
    if not force_stub and llama_weights_available(llama_path):
        if checkout_model_type(llama_path) == "deepseek_v2":
            if quant is not None or (mesh is not None and mesh.n_model > 1):
                raise ValueError("the deepseek_v2 encoder runs bf16, whole on each rank: no quant, no model axis")
            from cse_tpu_torch.models.deepseek_v2 import DeepseekV2ContextEncoder

            return DeepseekV2ContextEncoder(llama_path, ctx_length=ctx_length, device=device)
        from cse_tpu_torch.models.llama import LlamaContextEncoder

        return LlamaContextEncoder(llama_path, ctx_length=ctx_length, quant=quant, device=device, mesh=mesh)
    enc = HashProjectionEncoder(dim=dim, ctx_length=ctx_length)
    return enc if device is None else enc.to(device)
