"""Seeded weights and inputs of a Sepformer configuration, made by the benchmark.

The benchmark draws every weight itself, on the device, from ``--seed``: one
normal draw for all leaves from a ``torch.Generator`` on that device, each
leaf a slice of it scaled by its initialiser; the decoder takes the
encoder's filters (:func:`draw_weights`). The program gets the same
tensors through ``load_state_dict(strict=True)``, so a name or shape that
the program does not have fails there; the plain reference gets them as a
dict. Neither side's initialiser is used.

The names are the port's (the reference implementation's SpeechBrain-style
module names): the parameter list below is this benchmark's own copy of the
architecture, not read from the program.
"""

from __future__ import annotations

import math

import torch


def param_spec(cfg: dict) -> list[tuple[str, tuple[int, ...]]]:
    """Every parameter of the configuration, as (name, shape)."""
    N, D, F, k = cfg["enc_channels"], cfg["d_model"], cfg["d_ffn"], cfg["enc_kernel"]
    spk = cfg["num_spks"]
    add_ctx = cfg["variant"] in ("contsep", "context")
    spec = [("encoder.weight", (N, 1, k)), ("masknet.prelu_alpha", (1,)),
            ("masknet.norm.weight", (N,)), ("masknet.norm.bias", (N,)), ("masknet.conv1d.weight", (D, N))]
    for i in range(cfg["num_dp_layers"]):
        blk = f"masknet.dual_mdl.{i}"
        for view in ("intra", "inter"):
            stack = f"{blk}.{view}_mdl"
            for j in range(cfg["num_tf_layers"]):
                lyr = f"{stack}.layers.{j}"
                spec += [(f"{lyr}.norm1.weight", (D,)), (f"{lyr}.norm1.bias", (D,)),
                         (f"{lyr}.self_att.in_proj.weight", (3 * D, D)), (f"{lyr}.self_att.in_proj.bias", (3 * D,)),
                         (f"{lyr}.self_att.out_proj.weight", (D, D)), (f"{lyr}.self_att.out_proj.bias", (D,)),
                         (f"{lyr}.norm2.weight", (D,)), (f"{lyr}.norm2.bias", (D,)),
                         (f"{lyr}.ffn_1.weight", (F, D)), (f"{lyr}.ffn_1.bias", (F,)),
                         (f"{lyr}.ffn_2.weight", (D, F)), (f"{lyr}.ffn_2.bias", (D,))]
            spec += [(f"{stack}.norm.weight", (D,)), (f"{stack}.norm.bias", (D,)),
                     (f"{blk}.{view}_norm.weight", (D,)), (f"{blk}.{view}_norm.bias", (D,))]
        if add_ctx:
            for view in ("intra", "inter"):
                spec += [(f"{blk}.{view}_context_mapper.weight", (D, cfg["llm_dim"])),
                         (f"{blk}.{view}_context_mapper.bias", (D,))]
    spec += [("masknet.conv2d.weight", (D * spk, D)), ("masknet.conv2d.bias", (D * spk,)),
             ("masknet.output.weight", (D, D)), ("masknet.output.bias", (D,)),
             ("masknet.output_gate.weight", (D, D)), ("masknet.output_gate.bias", (D,)),
             ("masknet.end_conv1x1.weight", (N, D)), ("decoder.weight", (N, 1, k))]
    if cfg["variant"] == "contsep":
        n_out = 1 if (spk == 2 and not cfg["ce"]) else spk
        spec += [("context_selector.weight", (n_out, D)), ("context_selector.bias", (n_out,))]
    return spec


def _scaled(name: str, z: torch.Tensor, shape) -> torch.Tensor:
    """One leaf from its slice of standard normals: matrices and kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.05^2), biases and norm offsets
    N(0, 0.02^2), the PReLU slope 0.25."""
    leaf = name.rsplit(".", 1)[-1]
    owner = name.rsplit(".", 2)[-2]
    if leaf == "prelu_alpha":
        return torch.full(shape, 0.25, device=z.device)
    if leaf == "bias":
        return 0.02 * z
    if "norm" in owner:
        return 1.0 + 0.05 * z
    fan_in = shape[0] * shape[2] if name == "decoder.weight" else math.prod(shape[1:])
    return z / math.sqrt(fan_in)


def draw_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """fp32 weights of ``cfg`` on ``device``, the same for the same seed."""
    spec = param_spec(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(sum(math.prod(s) for _, s in spec), generator=gen, device=device)
    out, at = {}, 0
    for name, shape in spec:
        n = math.prod(shape)
        out[name] = _scaled(name, z[at:at + n].view(shape), shape).contiguous()
        at += n
    # the decoder synthesises with the encoder's filters (scaled to its own fan-in), as a trained
    # analysis/synthesis pair does: with an independent random decoder every output is all but
    # orthogonal to its target (|corr| down to 2e-4), where -SI-SNR and its gradient are singular
    out["decoder.weight"] = out["encoder.weight"] / math.sqrt(cfg["enc_channels"])
    return out


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator for one stream of the run's draws (inputs, sampling),
    seeded from ``seed`` so that no two streams share their numbers."""
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + 7919 * stream) % (1 << 63))
