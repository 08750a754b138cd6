"""Separation losses of the training step, batched, in plain PyTorch.

Port of ``cse_tpu/ops/losses.py`` (``si_snr``, ``neg_si_snr_loss``,
``pit_si_snr_loss``, ``ctx_selection_loss``); the metrics of the eval path
(``sdr``, ``selection_accuracy``) come with that slice.

* ``si_snr`` — scale-invariant SNR in its projection form (speechbrain's
  ``cal_si_snr``, eps 1e-8), zero-mean by default.
* ``pit_si_snr_loss`` — permutation-invariant -SI-SNR over 2-3 sources, the
  permutations enumerated in a static table and scored in one pass.
* ``ctx_selection_loss`` — the selector head's CE over speakers, or the
  numerically stable BCE-with-logits on a single logit.
"""

from __future__ import annotations

import itertools

import torch

# speechbrain's cal_si_snr epsilon (loss path)
SB_EPS = 1e-8


def si_snr(pred: torch.Tensor, target: torch.Tensor, zero_mean: bool = True,
           eps: float = SB_EPS) -> torch.Tensor:
    """Scale-invariant SNR in dB along the last axis: ``[..., T] -> [...]``.

    s_t = (<pred, target> / (||target||^2 + eps)) * target,
    si_snr = 10 log10(||s_t||^2 / (||pred - s_t||^2 + eps) + eps).
    """
    pred, target = pred.float(), target.float()
    if zero_mean:
        pred = pred - pred.mean(dim=-1, keepdim=True)
        target = target - target.mean(dim=-1, keepdim=True)
    dot = (pred * target).sum(dim=-1, keepdim=True)
    t_energy = (target * target).sum(dim=-1, keepdim=True) + eps
    proj = dot * target / t_energy
    noise = pred - proj
    ratio = (proj * proj).sum(dim=-1) / ((noise * noise).sum(dim=-1) + eps)
    return 10.0 * torch.log10(ratio + eps)


def neg_si_snr_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """-SI-SNR training loss (ContExt / H-ContExt objective), mean over batch."""
    return -si_snr(pred, target).mean()


def perm_table(n: int, device=None) -> torch.Tensor:
    """All permutations of ``range(n)`` as a ``[n!, n]`` int64 table."""
    return torch.tensor(list(itertools.permutations(range(n))), dtype=torch.long, device=device)


def pit_si_snr_loss(est: torch.Tensor, targets: torch.Tensor, return_perm: bool = False):
    """Permutation-invariant -SI-SNR.

    ``est``, ``targets``: ``[B, T, C]``. Returns the per-sample loss ``[B]``:
    the minimum over permutations of mean_c(-si_snr(est[perm[c]], targets[c]))
    (speechbrain's PitWrapper); with ``return_perm`` also the best
    permutation ``[B, C]``.
    """
    C = est.shape[-1]
    pair = si_snr(est.transpose(1, 2)[:, :, None, :], targets.transpose(1, 2)[:, None, :, :])  # [B, Ce, Ct]
    perms = perm_table(C, est.device)  # [P, C]: est index assigned to each target slot
    gathered = pair[:, perms, torch.arange(C, device=est.device)[None, :]]  # [B, P, C]
    scores = gathered.mean(dim=-1)  # [B, P]
    best = scores.argmax(dim=-1)
    loss = -scores.gather(1, best[:, None])[:, 0]
    if return_perm:
        return loss, perms[best]
    return loss


def ctx_selection_loss(logits: torch.Tensor, labels: torch.Tensor, use_ce: bool) -> torch.Tensor:
    """Selector-head loss: CE over ``[B, C]`` logits, or BCE-with-logits on
    ``[B, 1]``; ``labels`` are int ``[B]``."""
    if use_ce:
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(-1, labels[:, None].long()).mean()
    z = logits[:, 0]
    y = labels.float()
    return (torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-z.abs()))).mean()
