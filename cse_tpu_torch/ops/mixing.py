"""Batched mixture synthesis on the device.

Port of ``cse_tpu/ops/mixing.py``: the reference synthesizes mixtures per
sample in CPU DataLoader workers (``src/data/dataset_train_CSE.py:167-415``,
``mix_aud.py:3-96``); here the same math runs as plain functions on
``[B, T]`` tensors with explicit per-sample length tensors, on whatever
device the tensors live on.

Details kept from the reference:
* 2-spk mixing uses energy-preserving (a, b) weights; 3-spk applies raw gains
  (``dataset_train_CSE.py:436-442`` vs ``:484-496``);
* signal and noise energies are means over each signal's own (pre-padding)
  length, with the noise first truncated to the signal length;
* the final mixture (and scaled stems) are peak-normalized to 0.9;
* DEMAND noise addition follows torchaudio ``F.add_noise``: the noise is
  scaled so the resulting SNR equals the requested value (``:298``);
* the random shift is circular (``torch.roll``, ``:181``).
"""

from __future__ import annotations

import torch


def _length_mask(T: int, lengths: torch.Tensor) -> torch.Tensor:
    """[B, T] float mask of valid samples given [B] lengths."""
    return (torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]).float()


def peak_normalize(x: torch.Tensor, target: float = 0.9, eps: float = 1e-12) -> torch.Tensor:
    """Scale each waveform ``x [..., T]`` so its absolute peak is ``target``."""
    peak = x.abs().amax(dim=-1, keepdim=True)
    return x * (target / peak.clamp_min(eps))


def _masked_energy(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Mean energy over each signal's own valid length. x: [B, T] -> [B]."""
    mask = _length_mask(x.shape[-1], lengths)
    return (x * x * mask).sum(dim=-1) / lengths.float().clamp_min(1.0)


def _gain(snr_db, sig_energy, noise_energy):
    return torch.sqrt(10.0 ** (-snr_db / 10.0) * sig_energy / noise_energy.clamp_min(1e-12))


def _peak_scale(mixed):
    return 0.9 / mixed.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12)


def mix_2spk(signal, noise, snr_db, signal_len, noise_len):
    """Energy-preserving 2-speaker SNR mix (reference ``mix_audio``, pad=True).

    signal/noise: [B, T] zero-right-padded; snr_db/signal_len/noise_len: [B].
    Returns (mixed, signal_scaled, noise_scaled, mixed_len): the mixture is
    truncated to the signal's length and peak-normalized to 0.9, and all
    three outputs share that scale.
    """
    sig_mask = _length_mask(signal.shape[-1], signal_len)
    # the noise is truncated to the signal length before its energy is measured
    eff_noise_len = torch.minimum(noise_len, signal_len)
    noise = noise * sig_mask
    g = _gain(snr_db, _masked_energy(signal, signal_len), _masked_energy(noise, eff_noise_len))
    a = torch.sqrt(1.0 / (1.0 + g * g))[:, None]
    b = torch.sqrt(g * g / (1.0 + g * g))[:, None]
    signal = a * signal * sig_mask
    noise = b * noise
    mixed = signal + noise
    scale = _peak_scale(mixed)
    return mixed * scale, signal * scale, noise * scale, signal_len


def mix_3spk(signal, noise1, noise2, snr1_db, snr2_db, signal_len, noise1_len, noise2_len):
    """3-speaker mix with raw per-noise gains (reference ``mix_audio_3spk``).

    Returns (mixed, signal, noise1, noise2, mixed_len); mixed_len is the max
    of the three lengths (pad=True branch), everything peak-normed to 0.9.
    """
    sig_energy = _masked_energy(signal, signal_len)
    noise1 = _gain(snr1_db, sig_energy, _masked_energy(noise1, noise1_len))[:, None] * noise1
    noise2 = _gain(snr2_db, sig_energy, _masked_energy(noise2, noise2_len))[:, None] * noise2
    mixed = signal + noise1 + noise2
    scale = _peak_scale(mixed)
    mixed_len = torch.maximum(signal_len, torch.maximum(noise1_len, noise2_len))
    return mixed * scale, signal * scale, noise1 * scale, noise2 * scale, mixed_len


def add_noise_snr(waveform: torch.Tensor, noise: torch.Tensor, snr_db: torch.Tensor) -> torch.Tensor:
    """Add ``noise`` scaled so the result has the requested SNR (torchaudio
    ``F.add_noise``): scale = 10 ** ((snr_current - snr_target) / 20) with L2
    energies over the full buffer. waveform/noise: [B, T]; snr_db: [B]."""
    e_sig = (waveform * waveform).sum(dim=-1)
    e_noise = (noise * noise).sum(dim=-1).clamp_min(1e-12)
    snr_current = 10.0 * torch.log10(e_sig.clamp_min(1e-12) / e_noise)
    scale = 10.0 ** ((snr_current - snr_db) / 20.0)
    return waveform + scale[:, None] * noise


def circular_shift(x: torch.Tensor, shifts: torch.Tensor, lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Per-sample circular shift along time (``torch.roll`` per row).

    x: [B, T]; shifts: [B] ints (positive = shift right). The reference rolls
    the *unpadded* signal (``dataset_train_CSE.py:181``), so when ``lengths``
    is given the wrap happens modulo each sample's own valid length and the
    zero padding stays in place. One gather with modular indices.
    """
    T = x.shape[-1]
    pos = torch.arange(T, device=x.device)[None, :]
    shifts = shifts.long()[:, None]
    if lengths is None:
        return x.gather(-1, torch.remainder(pos - shifts, T))
    L = lengths.long()[:, None].clamp_min(1)
    out = x.gather(-1, torch.remainder(pos - shifts, L))
    return torch.where(pos < L, out, x)
