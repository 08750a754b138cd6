"""Speaker (enrollment) encoders producing 192-d embeddings for H-ContExt.

Port of ``cse_tpu/models/speaker_encoder.py``. The reference uses a frozen
speechbrain ECAPA-TDNN (``train_HContExt.py:165-171,367``; 192-d per
``ContExt.py:52``): :class:`cse_tpu_torch.models.ecapa.EcapaEncoder`, which
:func:`build_speaker_encoder` returns for ``--ecapa_path``. Without the
released weights it returns :class:`SpectralSpeakerEncoder`, a
deterministic spectral-statistics stand-in (frame log-spectrum moments,
fixed random projection): speaker-discriminative enough for smoke training,
NOT checkpoint-compatible; construction warns loudly.

The JAX package keeps one process-wide encoder; the port passes the encoder
to its callers. The stand-in's projection W ``[402, 192]`` is a buffer drawn
from a ``torch.Generator`` seeded with ``seed``; the JAX package draws its
own from ``jax.random``, and ``compat.jax_params.spectral_projection_from_jax``
carries it across.
"""

from __future__ import annotations

import math
import sys

import torch

from cse_tpu_torch.core.device import resolve_device
from cse_tpu_torch.models.ecapa import EcapaEncoder

FRAME = 400
FEAT = FRAME + 2  # [mean, std] of the 201 rfft bins
DIM = 192  # the ECAPA embedding's width (reference ContExt.py:52)


class SpectralSpeakerEncoder(torch.nn.Module):
    """wav [B, T], lengths -> [B, 1, 192]: the spectral-statistics stand-in."""

    is_stub = True

    def __init__(self, seed: int = 0, projection: torch.Tensor | None = None):
        super().__init__()
        if projection is None:
            projection = torch.randn(FEAT, DIM, generator=torch.Generator().manual_seed(seed)) / math.sqrt(FEAT)
        self.register_buffer("W", torch.as_tensor(projection, dtype=torch.float32).reshape(FEAT, DIM))
        print(
            "[cse_tpu_torch] WARNING: using SpectralSpeakerEncoder — the enrollment "
            "cue is a spectral-statistics stand-in, NOT ECAPA; released checkpoints "
            "will not be meaningful (pass --ecapa_path).",
            file=sys.stderr,
        )

    @torch.no_grad()
    def forward(self, wav, lengths=None) -> torch.Tensor:
        wav = torch.as_tensor(wav).to(self.W.device, torch.float32)
        if lengths is not None:
            lengths = torch.as_tensor(lengths).to(self.W.device)
        return _spectral_embedding(wav, lengths, self.W)


def _spectral_embedding(wav, lengths, W):
    """Frame log-spectrum moments, projected and L2-normalised. Frames past
    ``lengths`` (valid sample counts) are left out of the moments."""
    B, T = wav.shape
    n = max(T // FRAME, 1)
    x = wav[:, : n * FRAME].reshape(B, n, FRAME)
    win = torch.hann_window(FRAME, periodic=False, dtype=wav.dtype, device=wav.device)  # jnp.hanning
    logspec = torch.log(torch.fft.rfft(x * win, dim=-1).abs() + 1e-6)  # [B, n, F]
    if lengths is not None:
        valid = torch.clamp(lengths // FRAME, min=1)
        m = (torch.arange(n, device=wav.device)[None, :] < valid[:, None]).to(logspec.dtype)[..., None]
        denom = m.sum(dim=1).clamp_min(1.0)
        mu = (logspec * m).sum(dim=1) / denom
        sd = torch.sqrt(((logspec - mu[:, None, :]) ** 2 * m).sum(dim=1) / denom)
    else:
        mu = logspec.mean(dim=1)
        sd = logspec.std(dim=1, correction=0)  # jnp.std: the population std
    emb = torch.cat([mu, sd], dim=-1) @ W
    emb = emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-6)
    return emb[:, None, :]


def build_speaker_encoder(ecapa_weights: str | None = None, device=None):
    """The encoder ``encode_speaker`` runs, on ``device`` (the card unless
    ``device="cpu"``): the frozen ECAPA for a speechbrain ``.ckpt`` path,
    else the stand-in."""
    dev = resolve_device(device)
    if ecapa_weights:
        return EcapaEncoder(ecapa_weights, device=dev)
    return SpectralSpeakerEncoder().to(dev)


def encode_speaker(encoder, wav, lengths=None) -> torch.Tensor:
    """Speaker embedding of enrollment audio [B, T] @16k -> [B, 1, 192].

    ``lengths``: per-row valid sample counts of the zero-padded buffers,
    as the reference passes ``wav_lens`` to speechbrain's ``encode_batch``."""
    return encoder(wav, lengths)
