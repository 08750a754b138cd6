"""Checkpoint save/restore with reference-compatible naming and semantics.

Port of ``cse_tpu/train/checkpoint.py`` on ``torch.save`` / ``torch.load``.
The reference's contract (``train_ContSep.py:179-211,458-513``):
* files named ``Epoch_%04d_%05d_%.2f.ckpt`` (epoch, step, val SI-SNR) plus a
  single rolling ``Best_*.ckpt`` (the previous best is deleted);
* ``--resume`` picks the newest checkpoint by the step parsed from the name;
* weights-only warm start vs full restore (``--from_ckpt``) of optimizer,
  plateau, step and epoch.

A checkpoint is one file holding ``{"format": FORMAT, "model": state_dict,
"opt_state": the optimizer's state as a dict (moments, counts, the MultiSteps
accumulator, the plateau scale), "step", "epoch", "best_val", "plateau"}``.
A released PyTorch checkpoint of the reference (a dict with a ``state_dict``,
or a bare state_dict) is read too, through
:mod:`cse_tpu_torch.compat.torch_import`, so both forms are consumable by the
same flag.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
from typing import Any

import torch

from cse_tpu_torch.compat.torch_import import released_form
from cse_tpu_torch.train.optimizer import OptState

FORMAT = "cse_tpu_torch/1"


def opt_state_to_dict(state: OptState) -> dict[str, Any]:
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}


def load_opt_state(state: OptState, saved: dict[str, Any]) -> OptState:
    """Copy a saved optimizer state into ``state`` in place (tensors keep
    their device); returns it."""
    for f in dataclasses.fields(state):
        cur, new = getattr(state, f.name), saved[f.name]
        if isinstance(cur, list):
            if new is None or len(new) != len(cur):
                raise ValueError(f"checkpoint optimizer state {f.name!r} does not fit this model")
            for c, n in zip(cur, new):
                c.copy_(n)
        else:
            setattr(state, f.name, new)
    return state


def save_checkpoint(
    checkpoint_dir: str,
    epoch: int,
    step: int,
    val_sisnr: float,
    state: dict[str, Any],
    best: bool = False,
) -> str:
    """Write ``state`` (model / opt_state / step / epoch / best_val / plateau)
    to ``Epoch_%04d_%05d_%.2f.ckpt`` (or the rolling ``Best_*``)."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    prefix = "Best" if best else "Epoch"
    name = f"{prefix}_{epoch:04d}_{step:05d}_{val_sisnr:.2f}.ckpt"
    path = os.path.abspath(os.path.join(checkpoint_dir, name))
    prev_best = [
        p for p in glob.glob(os.path.join(checkpoint_dir, "Best_*.ckpt"))
        if os.path.abspath(p) != path  # glob may yield relative paths
    ] if best else []
    state = dict(state, format=FORMAT)
    if isinstance(state.get("opt_state"), OptState):
        state["opt_state"] = opt_state_to_dict(state["opt_state"])
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    # roll the previous Best only AFTER the new one is fully written: a
    # crash mid-save must never leave the run without a best checkpoint
    for prev in prev_best:
        os.remove(prev)
    return path


def latest_checkpoint(checkpoint_dir: str) -> str | None:
    """Newest checkpoint by step number parsed from the filename
    (reference ``train_ContSep.py:179-187``)."""
    ckpts = glob.glob(os.path.join(checkpoint_dir, "*.ckpt"))
    if not ckpts:
        return None

    def step_of(p):
        m = re.match(r".*_(\d+)_(\d+)_.*\.ckpt$", os.path.basename(p))
        return int(m.group(2)) if m else -1

    return max(ckpts, key=step_of)


def restore_checkpoint(path: str, map_location="cpu") -> dict[str, Any]:
    """Load a checkpoint written by :func:`save_checkpoint`, or a released
    PyTorch ``.ckpt`` of the reference, which comes back as
    ``{"state_dict": reference names -> fp32 CPU tensors, "step", "epoch",
    ...}`` for the caller to map through
    :func:`cse_tpu_torch.compat.torch_import.sepformer_from_state_dict`.
    Raises ValueError for a file of neither form."""
    obj = torch.load(path, map_location=map_location, weights_only=False)
    if isinstance(obj, dict) and obj.get("format") == FORMAT:
        return obj
    released = released_form(obj)
    if released is None:
        raise ValueError(f"cse_tpu_torch: {path!r} is neither a checkpoint of this package nor a released "
                         "PyTorch checkpoint of the reference")
    return released
