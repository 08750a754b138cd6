"""Batched polyphase sinc resampling on the device.

Port of ``cse_tpu/ops/resample.py``. The reference leans on three native
resamplers: torchaudio ``F.speed`` (speed perturbation,
``dataset_train_CSE.py:185-248``), torchaudio ``F.resample`` (8k->16k for
Whisper, ``test_cascaded.py:222``), and librosa (file-load 16k->8k,
``dataset_train_CSE.py:393-398``). All are windowed-sinc polyphase filters.
One implementation covers all three: the polyphase kernel bank is built on
the host in float64 (cached per rate pair; the same construction as
torchaudio's ``_get_sinc_resample_kernel``, and the same numpy code as the
JAX package's, so the taps are bit-identical), then applied as a single
strided ``conv1d`` batched over ``[B, T]``.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=64)
def resample_poly_filter(
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
    beta: float | None = None,
    window: str = "hann",
):
    """Build the polyphase kernel bank for orig_freq -> new_freq.

    Returns (kernel [new_r, 1, 2*width + orig_r], width, orig_r, new_r) with
    rates reduced by their gcd. ``window`` is 'hann' (torchaudio default, used
    by F.speed) or 'kaiser' (use with lowpass_filter_width=64 for
    librosa/soxr-grade file-load resampling).
    """
    g = math.gcd(int(orig_freq), int(new_freq))
    orig_r, new_r = int(orig_freq) // g, int(new_freq) // g
    if orig_r == new_r:
        return None, 0, orig_r, new_r

    base_freq = min(orig_r, new_r) * rolloff
    width = math.ceil(lowpass_filter_width * orig_r / base_freq)
    idx = np.arange(-width, width + orig_r, dtype=np.float64)[None, :] / orig_r
    t = (-np.arange(new_r, dtype=np.float64)[:, None] / new_r + idx) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    if window == "hann":
        win = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    elif window == "kaiser":
        if beta is None:
            beta = 14.769656459379492
        from scipy.special import i0

        win = i0(beta * np.sqrt(1 - (t / lowpass_filter_width) ** 2)) / i0(beta)
    else:
        raise ValueError(f"unknown window {window!r}")

    tt = t * np.pi
    kernel = np.where(tt == 0, 1.0, np.sin(tt) / np.where(tt == 0, 1.0, tt))
    kernel = kernel * win * (base_freq / orig_r)
    return kernel[:, None, :].astype(np.float32), width, orig_r, new_r


@lru_cache(maxsize=64)
def _filter_on(device: torch.device, *key):
    """The kernel bank of :func:`resample_poly_filter` as a tensor on ``device``
    (cached, so a call costs no host-to-device copy after the first)."""
    kernel, width, orig_r, new_r = resample_poly_filter(*key)
    return (None if kernel is None else torch.from_numpy(kernel).to(device)), width, orig_r, new_r


def resample(
    x: torch.Tensor,
    orig_freq: int,
    new_freq: int,
    lengths: torch.Tensor | None = None,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
    window: str = "hann",
    beta: float | None = None,
):
    """Resample ``x [..., T]`` from orig_freq to new_freq.

    Returns (y [..., T_out], new_lengths) where T_out = ceil(T*new/orig).
    ``lengths`` (optional, [...]) tracks per-sample valid lengths through the
    rate change. Matches torchaudio ``F.resample`` output sample-for-sample.
    """
    kernel, width, orig_r, new_r = _filter_on(
        x.device, orig_freq, new_freq, lowpass_filter_width, rolloff, beta, window
    )
    T = x.shape[-1]
    if kernel is None:
        return x, lengths
    lead_shape = x.shape[:-1]
    xf = x.reshape(-1, 1, T).float()
    # asymmetric padding (width, width + orig_r), which conv1d's padding= cannot express
    xf = F.pad(xf, (width, width + orig_r))
    out = F.conv1d(xf, kernel, stride=orig_r)  # [B, new_r, frames]
    out = out.transpose(1, 2).reshape(xf.shape[0], -1)
    T_out = int(math.ceil(T * new_r / orig_r))
    out = out[:, :T_out].reshape(*lead_shape, T_out)
    new_lengths = None
    if lengths is not None:
        new_lengths = torch.ceil(lengths.float() * new_r / orig_r).to(lengths.dtype)
    return out, new_lengths


def speed_perturb(
    x: torch.Tensor,
    lengths: torch.Tensor,
    factor_idx: torch.Tensor,
    factors: tuple[float, ...] = (0.9, 1.0, 1.1),
    sr: int = 16000,
):
    """Per-sample speed perturbation by a choice of static factors.

    torchaudio ``F.speed(x, sr, f)`` == resample(x, int(sr*f), sr)
    (reference ``dataset_train_CSE.py:185``). Each sample draws its own
    factor; all factor branches are computed into a shared ``[B, T_out]``
    buffer and the per-sample result is gathered by ``factor_idx``: no
    host-side branching on device data.

    Returns (y [B, T_out], new_lengths [B]) with T_out = ceil(T / min(factors)).
    """
    B, T = x.shape
    T_out = int(math.ceil(T / min(factors)))
    outs, lens = [], []
    for f in factors:
        src = int(round(sr * f))
        y, nl = resample(x, src, sr, lengths=lengths)
        pad = T_out - y.shape[-1]
        y = F.pad(y, (0, pad)) if pad > 0 else y[:, :T_out]
        outs.append(y)
        lens.append(nl.clamp_max(T_out) if nl is not None else lengths)
    stacked = torch.stack(outs, dim=0)  # [F, B, T_out]
    stacked_len = torch.stack(lens, dim=0)  # [F, B]
    sel = factor_idx.long()
    y = stacked.gather(0, sel[None, :, None].expand(1, B, T_out))[0]
    nl = stacked_len.gather(0, sel[None, :])[0]
    # zero out beyond the new valid length (resampler tails may extend past it)
    y = y * (torch.arange(T_out, device=x.device)[None, :] < nl[:, None]).to(y.dtype)
    return y, nl
