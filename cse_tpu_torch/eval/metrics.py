"""Evaluation metrics: float64 host implementations + streaming accumulators.

The port's copy of ``cse_tpu/eval/metrics.py`` (the same numpy code).

Reported numbers (SI-SNR / SDR / improvements / selection accuracy) follow the
reference eval protocol (``test.py:198-201,248-255,291-310``): torchmetrics
semantics, improvements = metric(pred) - metric(mixture). The hot device path
uses the float32 torch versions in :mod:`cse_tpu_torch.ops.losses`; the accumulators
here recompute in float64 on host for the written result files so numbers are
bit-stable across backends.
"""

from __future__ import annotations

import numpy as np


def si_snr_numpy(pred: np.ndarray, target: np.ndarray, zero_mean: bool = True) -> np.ndarray:
    """SI-SNR in dB along the last axis, float64, torchmetrics convention."""
    pred = np.asarray(pred, np.float64)
    target = np.asarray(target, np.float64)
    eps = np.finfo(np.float64).eps
    if zero_mean:
        pred = pred - pred.mean(-1, keepdims=True)
        target = target - target.mean(-1, keepdims=True)
    alpha = ((pred * target).sum(-1, keepdims=True) + eps) / (
        (target**2).sum(-1, keepdims=True) + eps
    )
    scaled = alpha * target
    noise = scaled - pred
    val = ((scaled**2).sum(-1) + eps) / ((noise**2).sum(-1) + eps)
    return 10.0 * np.log10(val)


def sdr_numpy(
    pred: np.ndarray,
    target: np.ndarray,
    filter_length: int = 512,
    zero_mean: bool = False,
    load_diag: float | None = None,
) -> np.ndarray:
    """Filter-based SDR (torchmetrics ``SignalDistortionRatio`` semantics).

    Fits a length-512 distortion filter by solving the Toeplitz normal
    equations on the unit-normalized signals; SDR = 10log10(coh/(1-coh)).
    """
    from scipy.linalg import solve_toeplitz

    pred = np.asarray(pred, np.float64)
    target = np.asarray(target, np.float64)
    if zero_mean:
        pred = pred - pred.mean(-1, keepdims=True)
        target = target - target.mean(-1, keepdims=True)
    target = target / np.maximum(np.linalg.norm(target, axis=-1, keepdims=True), 1e-6)
    pred = pred / np.maximum(np.linalg.norm(pred, axis=-1, keepdims=True), 1e-6)

    T = pred.shape[-1]
    n_fft = 1
    while n_fft < T + filter_length:
        n_fft *= 2
    t_fft = np.fft.rfft(target, n=n_fft, axis=-1)
    p_fft = np.fft.rfft(pred, n=n_fft, axis=-1)
    acf = np.fft.irfft(np.abs(t_fft) ** 2, n=n_fft, axis=-1)[..., :filter_length]
    xcorr = np.fft.irfft(np.conj(t_fft) * p_fft, n=n_fft, axis=-1)[..., :filter_length]
    if load_diag is not None:
        acf[..., 0] += load_diag

    flat_a = acf.reshape(-1, filter_length)
    flat_x = xcorr.reshape(-1, filter_length)
    out = np.empty(flat_a.shape[0])
    eps = np.finfo(np.float64).eps
    for i in range(flat_a.shape[0]):
        try:
            sol = solve_toeplitz(flat_a[i], flat_x[i])
        except np.linalg.LinAlgError:
            # degenerate (e.g. silent) target: regularize instead of aborting
            # the whole evaluation (torchmetrics' use_cg_iter path does the
            # same in spirit)
            reg = flat_a[i].copy()
            reg[0] += max(1e-8, 1e-8 * abs(reg[0]))
            sol = solve_toeplitz(reg, flat_x[i])
        coh = float(flat_x[i] @ sol)
        out[i] = 10.0 * np.log10(max(coh, eps) / max(1.0 - coh, eps))
    return out.reshape(pred.shape[:-1])


class MeanMetric:
    """Streaming mean accumulator (torchmetrics-style .update()/.compute())."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    def update(self, values: np.ndarray):
        values = np.asarray(values, np.float64).reshape(-1)
        self.total += float(values.sum())
        self.count += values.size

    def compute(self) -> float:
        # empty accumulator -> NaN (torchmetrics semantics): 0.0 dB would
        # read as a measured score and mask a misconfigured eval list
        if self.count == 0:
            return float("nan")
        return self.total / self.count


class SiSnrMetric(MeanMetric):
    def update(self, pred: np.ndarray, target: np.ndarray):  # type: ignore[override]
        super().update(si_snr_numpy(pred, target))


class SdrMetric(MeanMetric):
    def update(self, pred: np.ndarray, target: np.ndarray):  # type: ignore[override]
        super().update(sdr_numpy(pred, target))
