"""Import released PyTorch checkpoints of the reference into the port's Sepformer.

Port of ``cse_tpu/compat/torch_import.py``. The reference releases ``.ckpt``
files written by ``torch.save`` with a flat ``state_dict`` (reference
``train_ContSep.py:488-497``; the key layout is set by
``src/models/ContSep.py`` / ``ContExt.py`` and the speechbrain lobes they
instantiate). This module maps those keys onto the port's ``state_dict``
(:class:`cse_tpu_torch.models.sepformer.Sepformer`), which keeps the
reference's module tree with these differences:

* the encoder's ``Conv1d`` is ``encoder.conv1d`` there and ``encoder`` here;
* the 1x1 convolutions (``masknet.conv1d``, ``conv2d``, ``output.0``,
  ``output_gate.0``, ``end_conv1x1``) are ``nn.Linear`` here: the kernel dims
  are squeezed, the ``output.0`` / ``output_gate.0`` wrappers dropped;
* the speechbrain wrappers of a transformer layer (``mdl.``, ``att.``,
  ``norm.``, ``pos_ffn.ffn.0`` / ``.3``) are flattened: ``self_att.in_proj``,
  ``norm1``, ``ffn_1``, ``ffn_2``;
* ``masknet.prelu.weight`` is ``masknet.prelu_alpha``.

The decoder's ``ConvTranspose1d`` weight keeps its layout and orientation:
both sides run ``F.conv_transpose1d`` on it, so it is copied unflipped.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import torch


def layout(num_dp_layers: int, num_tf_layers: int, context: bool, selector: bool, se: bool):
    """``(port name, reference name, squeezed dims)`` of every parameter of a
    Sepformer with these counts and optional heads: the reference tensor is
    the port's with ``squeezed dims`` trailing 1s (a 1x1 convolution's
    kernel). Shared by the import and :mod:`.torch_export`, so one inverts
    the other."""
    out = [("encoder.weight", "encoder.conv1d.weight", 0), ("decoder.weight", "decoder.weight", 0),
           ("masknet.norm.weight", "masknet.norm.weight", 0), ("masknet.norm.bias", "masknet.norm.bias", 0),
           ("masknet.conv1d.weight", "masknet.conv1d.weight", 1)]
    layer_parts = (("self_att.in_proj.weight", "self_att.att.in_proj_weight"),
                   ("self_att.in_proj.bias", "self_att.att.in_proj_bias"),
                   ("self_att.out_proj.weight", "self_att.att.out_proj.weight"),
                   ("self_att.out_proj.bias", "self_att.att.out_proj.bias"),
                   ("norm1.weight", "norm1.norm.weight"), ("norm1.bias", "norm1.norm.bias"),
                   ("norm2.weight", "norm2.norm.weight"), ("norm2.bias", "norm2.norm.bias"),
                   ("ffn_1.weight", "pos_ffn.ffn.0.weight"), ("ffn_1.bias", "pos_ffn.ffn.0.bias"),
                   ("ffn_2.weight", "pos_ffn.ffn.3.weight"), ("ffn_2.bias", "pos_ffn.ffn.3.bias"))
    for i in range(num_dp_layers):
        dp = f"masknet.dual_mdl.{i}"
        for stack in ("intra_mdl", "inter_mdl"):
            for j in range(num_tf_layers):
                out += [(f"{dp}.{stack}.layers.{j}.{p}", f"{dp}.{stack}.mdl.layers.{j}.{r}", 0)
                        for p, r in layer_parts]
            out += [(f"{dp}.{stack}.norm.{w}", f"{dp}.{stack}.mdl.norm.norm.{w}", 0) for w in ("weight", "bias")]
        names = ["intra_norm.weight", "intra_norm.bias", "inter_norm.weight", "inter_norm.bias"]
        if context:
            names += [f"{m}_context_mapper.{w}" for m in ("intra", "inter") for w in ("weight", "bias")]
        out += [(f"{dp}.{n}", f"{dp}.{n}", 0) for n in names]
    out += [("masknet.prelu_alpha", "masknet.prelu.weight", 0),
            ("masknet.conv2d.weight", "masknet.conv2d.weight", 2), ("masknet.conv2d.bias", "masknet.conv2d.bias", 0),
            ("masknet.output.weight", "masknet.output.0.weight", 1), ("masknet.output.bias", "masknet.output.0.bias", 0),
            ("masknet.output_gate.weight", "masknet.output_gate.0.weight", 1),
            ("masknet.output_gate.bias", "masknet.output_gate.0.bias", 0),
            ("masknet.end_conv1x1.weight", "masknet.end_conv1x1.weight", 1)]
    for head, on in (("context_selector", selector), ("se_embedding", se)):
        if on:
            out += [(f"{head}.{w}", f"{head}.{w}", 0) for w in ("weight", "bias")]
    return out


def released_form(obj: Any) -> dict[str, Any] | None:
    """A loaded released checkpoint (``{"state_dict": ..., "step", "epoch",
    ...}`` or a bare state_dict) as ``{**obj, "state_dict": fp32 CPU
    tensors}``; None for anything else."""
    if not isinstance(obj, Mapping):
        return None
    if not isinstance(obj.get("state_dict"), Mapping):
        if "encoder.conv1d.weight" not in obj:
            return None
        obj = {"state_dict": obj}  # a bare state_dict
    sd = obj["state_dict"]
    if not all(isinstance(v, torch.Tensor) for v in sd.values()):
        return None
    return {**obj, "state_dict": {k: v.detach().cpu().float() for k, v in sd.items()}}


def load_torch_checkpoint(path: str) -> dict[str, Any]:
    """torch.load a reference ``.ckpt`` and return its dict (state_dict /
    optimizer_state_dict / scheduler_state_dict / step / epoch); bare
    state_dicts are accepted. Raises ValueError for any other file."""
    got = released_form(torch.load(path, map_location="cpu", weights_only=False))
    if got is None:
        raise ValueError(f"{path!r} is not a released PyTorch checkpoint (no state_dict of the reference)")
    return got


def sepformer_from_state_dict(sd: Mapping[str, torch.Tensor], num_dp_layers: int = 2,
                              num_tf_layers: int = 8) -> dict[str, torch.Tensor]:
    """A reference Sepformer / ContSep / ContExt state_dict -> the port's
    ``state_dict`` (fp32 CPU tensors) for ``Sepformer.load_state_dict``
    (strict). The optional heads (context mappers, selector, se embedding)
    are detected from the keys; keys of the reference that the model does
    not use are ignored, a missing one raises KeyError."""
    names = layout(num_dp_layers, num_tf_layers, "masknet.dual_mdl.0.intra_context_mapper.weight" in sd,
                   "context_selector.weight" in sd, "se_embedding.weight" in sd)
    out = {}
    for port, ref, squeezed in names:
        t = torch.as_tensor(sd[ref]).detach().cpu().float()
        out[port] = t.reshape(t.shape[: t.ndim - squeezed]).clone()
    return out


def infer_reference_config(sd: Mapping[str, Any]) -> dict:
    """Infer (num_spks, variant flags, dp/tf layer counts) from key shapes."""
    d_model = sd["masknet.conv1d.weight"].shape[0]
    num_spks = sd["masknet.conv2d.weight"].shape[0] // d_model
    num_dp = 1 + max(
        int(m.group(1))
        for k in sd
        if (m := re.match(r"masknet\.dual_mdl\.(\d+)\.", k))
    )
    num_tf = 1 + max(
        int(m.group(1))
        for k in sd
        if (m := re.search(r"\.mdl\.layers\.(\d+)\.", k))
    )
    has_ctx = any("context_mapper" in k for k in sd)
    has_selector = "context_selector.weight" in sd
    has_se = "se_embedding.weight" in sd
    variant = "contsep" if has_selector else ("context" if has_ctx else "base")
    ce = not (has_selector and sd["context_selector.weight"].shape[0] == 1)
    return dict(
        num_spks=num_spks,
        num_dp_layers=num_dp,
        num_tf_layers=num_tf,
        variant=variant,
        ce=ce,
        add_se=has_se,
    )
