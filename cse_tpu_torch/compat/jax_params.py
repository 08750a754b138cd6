"""Carry ``cse_tpu`` flax Sepformer parameters into the port's modules.

The port keeps its own copy of the layout rules (it imports nothing of
``cse_tpu``):

* flax ``Dense`` kernels are ``[din, dout]``; ``nn.Linear`` weights are
  ``[dout, din]`` -> transposed;
* the encoder ``Conv`` kernel is HIO ``[k, 1, N]``; ``nn.Conv1d`` wants
  ``[N, 1, k]``;
* the decoder is ``jax.lax.conv_transpose`` with an HIO ``[k, N, 1]`` kernel
  and no flip, so ``F.conv_transpose1d`` needs the kernel reversed along k
  (``[N, 1, k]``);
* LayerNorm / GroupNorm ``scale`` -> ``weight``; ``dual_mdl_{i}`` ->
  ``dual_mdl.{i}``; ``layer_{j}`` -> ``layers.{j}``; the packed attention's
  ``in_proj_kernel`` / ``out_proj_kernel`` -> ``in_proj`` / ``out_proj``.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


def _leaves(tree: Mapping, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, dtype=np.float32)


def _module_path(path: tuple) -> list[str]:
    out = []
    for seg in path:
        m = re.fullmatch(r"(dual_mdl|layer)_(\d+)", seg)
        if m:
            out += ["dual_mdl" if m.group(1) == "dual_mdl" else "layers", m.group(2)]
        else:
            out.append(seg)
    return out


def jax_params_to_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax Sepformer params (``{"params": ...}`` or the bare tree, leaves
    array-like) -> the port's ``state_dict`` (fp32 CPU tensors)."""
    p = params["params"] if "params" in params else params
    sd = {}
    for path, a in _leaves(p):
        *mods, leaf = _module_path(path)
        if mods == ["encoder"] and leaf == "kernel":
            t = a.transpose(2, 1, 0)
        elif mods == ["decoder"] and leaf == "kernel":
            t = a[::-1].transpose(1, 2, 0)
        elif leaf in ("kernel", "in_proj_kernel", "out_proj_kernel"):
            t = a.T
        else:
            t = a
        if leaf in ("in_proj_kernel", "out_proj_kernel", "in_proj_bias", "out_proj_bias"):
            proj, kind = leaf.rsplit("_", 1)
            mods, leaf = mods + [proj], "bias" if kind == "bias" else "kernel"
        name = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
        sd[".".join(mods + [name])] = torch.from_numpy(np.array(t))  # a writable copy
    return sd


def load_jax_params(model: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Load flax params into ``model`` strictly: a missing or unexpected key,
    or a shape mismatch, raises."""
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model


def hash_encoder_tables(w, p) -> tuple[torch.Tensor, torch.Tensor]:
    """The two ``[dim]`` tables of the JAX package's ``HashProjectionEncoder``
    (``models/context_encoder.py:64-66``: ``w = normal(key) * 0.02``, ``p =
    uniform(fold_in(key, 1)) * 6.283``, given here as numpy arrays of any
    shape with ``dim`` entries) as fp32 tensors for
    ``HashProjectionEncoder(tables=...)``: the port draws its default tables
    from a ``torch.Generator``, so the caller carries JAX's across to compare
    the same function on the same tables."""
    return tuple(torch.from_numpy(np.array(t, dtype=np.float32).reshape(-1)) for t in (w, p))


def llama_params_from_jax(params: Mapping[str, Any], device="cpu") -> dict:
    """``cse_tpu``'s Llama weight tree (numpy leaves) -> the port's
    (``models/llama.py``), the same stacked layout: bf16 / fp32 leaves as
    they are, int8 payloads under ``"w"`` (weight-only) or ``"w8"`` (w8a8,
    stored K-major as the port's loader keeps them) and their fp32 scales
    ``"s"``. numpy has no bf16: a JAX bf16 leaf arrives as ml_dtypes' bfloat16
    and is read through its bits."""
    def leaf(x, key):
        x = np.asarray(x)
        if x.dtype.name == "bfloat16":
            t = torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(x))
        t = t.to(device)
        return t.transpose(-1, -2).contiguous().transpose(-1, -2) if key == "w8" else t

    def tree(node, key=None):
        if isinstance(node, Mapping):
            return {k: tree(v, k) for k, v in node.items()}
        return leaf(node, key)

    return tree(params)


def _conv(w) -> torch.Tensor:
    """A JAX conv kernel HIO ``[k, in, out]`` -> torch's ``[out, in, k]``."""
    return torch.from_numpy(np.array(np.asarray(w, np.float32).transpose(2, 1, 0)))


def _vec(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32))


def _ecapa_bn(p: Mapping, prefix: str) -> dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _vec(p["scale"]), f"{prefix}.bias": _vec(p["bias"]),
            f"{prefix}.running_mean": _vec(p["mean"]), f"{prefix}.running_var": _vec(p["var"]),
            f"{prefix}.num_batches_tracked": torch.tensor(0)}


def _ecapa_tdnn(p: Mapping, prefix: str) -> dict[str, torch.Tensor]:
    return {f"{prefix}.conv.conv.weight": _conv(p["w"]), f"{prefix}.conv.conv.bias": _vec(p["b"]),
            **_ecapa_bn(p["bn"], f"{prefix}.norm.norm")}


def ecapa_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``cse_tpu``'s ECAPA tree (``random_ecapa_params`` /
    ``ecapa_from_state_dict``; numpy leaves) -> the speechbrain-layout
    ``state_dict`` of ``models/ecapa.py::EcapaTDNN`` (fp32 CPU tensors):
    ``ecapa_from_state_dict`` run backwards."""
    sd = _ecapa_tdnn(params["layer1"], "blocks.0")
    for li in range(3):
        layer, bp = params[f"layer{li + 2}"], f"blocks.{li + 1}"
        sd.update(_ecapa_tdnn(layer["tdnn1"], f"{bp}.tdnn1"))
        sd.update(_ecapa_tdnn(layer["tdnn2"], f"{bp}.tdnn2"))
        for i in range(len(layer["res2net"])):
            sd.update(_ecapa_tdnn(layer["res2net"][f"block_{i}"], f"{bp}.res2net_block.blocks.{i}"))
        se = layer["se"]
        sd.update({f"{bp}.se_block.conv1.conv.weight": _conv(se["w1"]), f"{bp}.se_block.conv1.conv.bias": _vec(se["b1"]),
                   f"{bp}.se_block.conv2.conv.weight": _conv(se["w2"]), f"{bp}.se_block.conv2.conv.bias": _vec(se["b2"])})
    sd.update(_ecapa_tdnn(params["mfa"], "mfa"))
    sd.update(_ecapa_tdnn(params["asp"]["tdnn"], "asp.tdnn"))
    sd.update({"asp.conv.conv.weight": _conv(params["asp"]["w"]), "asp.conv.conv.bias": _vec(params["asp"]["b"])})
    sd.update(_ecapa_bn(params["asp_bn"], "asp_bn.norm"))
    # fc is a bare speechbrain Conv1d (fc.conv.*): dense [6144, 192] -> k=1 conv [192, 6144, 1]
    sd.update({"fc.conv.weight": _vec(np.asarray(params["fc"]["w"]).T[:, :, None]), "fc.conv.bias": _vec(params["fc"]["b"])})
    return sd


def spectral_projection_from_jax(W) -> torch.Tensor:
    """The JAX package's spectral stand-in draws ``jax.random.normal(key(seed),
    (402, dim))`` (``models/speaker_encoder.py:45-46``) and divides it by
    sqrt(402); given that draw as a numpy array, the same projection as the
    buffer of ``SpectralSpeakerEncoder(projection=...)``."""
    w = _vec(W)
    return w / torch.sqrt(torch.tensor(float(w.shape[0])))


def whisper_state_dict_from_jax(params: Mapping[str, Any], n_audio_ctx: int = 1500) -> dict[str, torch.Tensor]:
    """``cse_tpu``'s Whisper tree (``random_whisper_params`` /
    ``whisper_from_state_dict``; numpy leaves, layers stacked on a leading
    axis) -> the OpenAI-layout ``state_dict`` of ``models/whisper.py::Whisper``
    (fp32 CPU tensors), for a strict load: ``[din, dout]`` matrices
    transposed, the HIO convolution kernels to ``[out, in, k]``, ``key`` with
    no bias, and ``encoder.positional_embedding`` (which the JAX tree does
    not hold) filled with the sinusoid table both packages compute, for
    ``n_audio_ctx`` positions."""
    from cse_tpu_torch.models.whisper import _sinusoids

    sd = {"encoder.conv1.weight": _conv(params["conv1_w"]), "encoder.conv1.bias": _vec(params["conv1_b"]),
          "encoder.conv2.weight": _conv(params["conv2_w"]), "encoder.conv2.bias": _vec(params["conv2_b"])}

    def ln(p, name):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = _vec(p["scale"]), _vec(p["bias"])

    def lin(w, b, name):
        sd[f"{name}.weight"] = torch.from_numpy(np.array(np.asarray(w, np.float32).T))
        if b is not None:
            sd[f"{name}.bias"] = _vec(b)

    def attn(p, name):
        lin(p["q_w"], p["q_b"], f"{name}.query")
        lin(p["k_w"], None, f"{name}.key")
        lin(p["v_w"], p["v_b"], f"{name}.value")
        lin(p["o_w"], p["o_b"], f"{name}.out")

    def layers(stacked):
        n = np.asarray(stacked["ln1"]["scale"]).shape[0]

        def pick(node, i):
            return {k: pick(v, i) for k, v in node.items()} if isinstance(node, Mapping) else np.asarray(node)[i]

        return [pick(stacked, i) for i in range(n)]

    for i, lp in enumerate(layers(params["enc_layers"])):
        p = f"encoder.blocks.{i}"
        ln(lp["ln1"], f"{p}.attn_ln")
        attn(lp["attn"], f"{p}.attn")
        ln(lp["ln2"], f"{p}.mlp_ln")
        lin(lp["mlp"]["w1"], lp["mlp"]["b1"], f"{p}.mlp.0")
        lin(lp["mlp"]["w2"], lp["mlp"]["b2"], f"{p}.mlp.2")
    ln(params["enc_ln_post"], "encoder.ln_post")
    for i, lp in enumerate(layers(params["dec_layers"])):
        p = f"decoder.blocks.{i}"
        ln(lp["ln1"], f"{p}.attn_ln")
        attn(lp["attn"], f"{p}.attn")
        ln(lp["ln2"], f"{p}.cross_attn_ln")
        attn(lp["cross"], f"{p}.cross_attn")
        ln(lp["ln3"], f"{p}.mlp_ln")
        lin(lp["mlp"]["w1"], lp["mlp"]["b1"], f"{p}.mlp.0")
        lin(lp["mlp"]["w2"], lp["mlp"]["b2"], f"{p}.mlp.2")
    ln(params["dec_ln"], "decoder.ln")
    sd["decoder.token_embedding.weight"] = _vec(params["tok_emb"])
    sd["decoder.positional_embedding"] = _vec(params["pos_emb"])
    sd["encoder.positional_embedding"] = torch.from_numpy(_sinusoids(n_audio_ctx, np.asarray(params["conv1_w"]).shape[2]))
    return sd
