"""Export the port's Sepformer to a reference-layout PyTorch ``.ckpt``.

Port of ``cse_tpu/compat/torch_export.py``, the inverse of
:mod:`cse_tpu_torch.compat.torch_import` (the same name table,
:func:`~cse_tpu_torch.compat.torch_import.layout`): models trained with the
port can be handed back to users of the reference implementation (its
state_dict key names and tensor layouts, loadable by the reference
``model.load_state_dict`` + ``torch.load`` flow, ``train_ContSep.py:189-211``).
"""

from __future__ import annotations

import re
from typing import Mapping

import torch
from torch import nn

from cse_tpu_torch.compat.torch_import import layout


def sepformer_to_state_dict(model: nn.Module | Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A port Sepformer (or its ``state_dict``) -> the reference's flat
    state_dict, fp32 CPU tensors."""
    sd = model.state_dict() if isinstance(model, nn.Module) else model
    num_dp = 1 + max(int(m.group(1)) for k in sd if (m := re.match(r"masknet\.dual_mdl\.(\d+)\.", k)))
    num_tf = 1 + max(int(m.group(1)) for k in sd if (m := re.search(r"\.layers\.(\d+)\.", k)))
    names = layout(num_dp, num_tf, "masknet.dual_mdl.0.intra_context_mapper.weight" in sd,
                   "context_selector.weight" in sd, "se_embedding.weight" in sd)
    out = {}
    for port, ref, squeezed in names:
        t = sd[port].detach().cpu().float()
        out[ref] = t.reshape(tuple(t.shape) + (1,) * squeezed).clone()
    return out


def save_torch_checkpoint(path: str, model: nn.Module | Mapping[str, torch.Tensor], step: int = 0,
                          epoch: int = 0):
    """Write a reference-loadable torch ``.ckpt`` (the weights-only warm-start form)."""
    torch.save(
        {
            "state_dict": sepformer_to_state_dict(model),
            "optimizer_state_dict": None,
            "scheduler_state_dict": None,
            "scaler": None,
            "step": step,
            "epoch": epoch,
        },
        path,
    )
