"""Separation losses of the training step, batched, in plain PyTorch.

Port of ``cse_tpu/ops/losses.py`` (``si_snr``, ``neg_si_snr_loss``,
``pit_si_snr_loss``, ``sdr``, ``selection_accuracy``, ``ctx_selection_loss``).

* ``si_snr`` — scale-invariant SNR in its projection form (speechbrain's
  ``cal_si_snr``, eps 1e-8), zero-mean by default.
* ``pit_si_snr_loss`` — permutation-invariant -SI-SNR over 2-3 sources, the
  permutations enumerated in a static table and scored in one pass.
* ``sdr`` — filter-based signal-to-distortion ratio with torchmetrics'
  ``SignalDistortionRatio`` defaults: a length-512 distortion filter fit by
  solving the Toeplitz normal equations in fp32.
* ``selection_accuracy`` — whether the picked stream is closer (SI-SNR) to
  the target than to every interferer.
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


def _toeplitz(c: torch.Tensor) -> torch.Tensor:
    """Symmetric Toeplitz matrix from its first column: ``[..., L] -> [..., L, L]``."""
    L = c.shape[-1]
    i = torch.arange(L, device=c.device)
    return c[..., (i[:, None] - i[None, :]).abs()]


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.solve`` (LU with partial pivoting, as ``jnp.linalg.solve``).

    On the CPU the systems are solved one at a time: a batched LU there (oneMKL)
    can print "Parameter 6 was incorrect on entry to SLASWP" and never return
    once the process has set more than one thread. The card keeps the batched
    call."""
    if a.device.type != "cpu":
        return torch.linalg.solve(a, b)
    lead = a.shape[:-2]
    a2, b2 = a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:])
    return torch.stack([torch.linalg.solve(a2[i], b2[i]) for i in range(a2.shape[0])]).reshape(*lead, *b.shape[-2:])


def sdr(pred: torch.Tensor, target: torch.Tensor, filter_length: int = 512, zero_mean: bool = False,
        load_diag: float | None = None) -> torch.Tensor:
    """Filter-based SDR in dB along the last axis: ``[..., T] -> [...]``.

    Fits a length-``filter_length`` FIR h minimising ||pred - h * target||
    through the normal equations (the Toeplitz autocorrelation system) on the
    unit-normalised signals; SDR = 10 log10(coh / (1 - coh)), coh the
    explained energy. The eval package recomputes reported numbers in
    float64 on the host (:mod:`cse_tpu_torch.eval.metrics`).
    """
    pred, target = pred.float(), target.float()
    if zero_mean:
        pred = pred - pred.mean(dim=-1, keepdim=True)
        target = target - target.mean(dim=-1, keepdim=True)
    eps = torch.finfo(torch.float32).eps
    target = target / torch.linalg.vector_norm(target, dim=-1, keepdim=True).clamp(min=1e-6)
    pred = pred / torch.linalg.vector_norm(pred, dim=-1, keepdim=True).clamp(min=1e-6)

    n_fft = _next_pow2(pred.shape[-1] + filter_length)
    t_fft = torch.fft.rfft(target, n=n_fft, dim=-1)
    p_fft = torch.fft.rfft(pred, n=n_fft, dim=-1)
    acf = torch.fft.irfft(t_fft.abs() ** 2, n=n_fft, dim=-1)[..., :filter_length]
    xcorr = torch.fft.irfft(t_fft.conj() * p_fft, n=n_fft, dim=-1)[..., :filter_length]
    if load_diag is not None:
        acf = torch.cat([acf[..., :1] + load_diag, acf[..., 1:]], dim=-1)
    sol = _solve(_toeplitz(acf), xcorr[..., None])[..., 0]
    coh = (xcorr * sol).sum(dim=-1)
    ratio = coh / (1.0 - coh).clamp(min=eps)
    return 10.0 * torch.log10(ratio.clamp(min=eps))


def selection_accuracy(pred_stream: torch.Tensor, gt: torch.Tensor, interferers: torch.Tensor) -> torch.Tensor:
    """1 where ``pred_stream`` [B, T] scores (SI-SNR) at least as high against
    ``gt`` [B, T] as against every interferer of ``interferers`` [B, T, C-1],
    else 0: int32 [B]."""
    gt_score = si_snr(pred_stream, gt)
    ok = torch.ones_like(gt_score, dtype=torch.int32)
    for c in range(interferers.shape[-1]):
        ok = ok * (gt_score >= si_snr(pred_stream, interferers[..., c])).to(torch.int32)
    return ok


def ctx_selection_loss(logits: torch.Tensor, labels: torch.Tensor, use_ce: bool) -> torch.Tensor:
    """Selector-head loss: CE over ``[B, C]`` logits, or BCE-with-logits on
    ``[B, 1]``; ``labels`` are int ``[B]``."""
    if use_ce:
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(-1, labels[:, None].long()).mean()
    z = logits[:, 0]
    y = labels.float()
    return (torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-z.abs()))).mean()
