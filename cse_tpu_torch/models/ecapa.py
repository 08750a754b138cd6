"""ECAPA-TDNN speaker encoder (H-ContExt's enrollment-cue network).

Port of ``cse_tpu/models/ecapa.py``. The reference uses a frozen speechbrain
``EncoderClassifier`` (``spkrec-ecapa-voxceleb``) producing 192-d speaker
embeddings (``train_HContExt.py:165-171,367``). The architecture (Desplanques
et al. 2020):

  fbank(80 mel, 25 ms / 10 ms) -> per-utterance mean norm
  -> TDNN(k5, 1024) -> 3x SE-Res2Net blocks (k3, dil 2/3/4, scale 8)
  -> concat -> TDNN(k1, 3072) -> attentive statistics pooling (global ctx)
  -> BN -> linear 6144 -> 192

The module keeps speechbrain's key names (``blocks.0``, ``blocks.{1..3}``
with ``tdnn1`` / ``res2net_block.blocks.{i}`` / ``tdnn2`` /
``se_block.conv{1,2}``, ``mfa``, ``asp.tdnn``, ``asp.conv``, ``asp_bn.norm``,
``fc``), so the released ``embedding_model.ckpt`` loads with
``load_state_dict(strict=True)``. Layout ``[B, C, T]``; inference only, fp32
(also under ``--bf16``), BatchNorm always on its running statistics. Under
PyTorch's defaults cuDNN may run the convolutions in TF32
(``torch.backends.cudnn.allow_tf32``); the card checks turn it off.

Like the JAX package, the convolutions pad with zeros (``'same'``,
``(k - 1) * dilation // 2``), where speechbrain's ``Conv1d`` reflects.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cse_tpu_torch.core.device import resolve_device

# ---------------------------------------------------------------------------
# features: 80-mel log filterbank, 25 ms window / 10 ms hop @ 16 kHz
# ---------------------------------------------------------------------------


@lru_cache(maxsize=4)
def _mel_matrix(n_mels=80, n_fft=400, sr=16000, f_min=0.0, f_max=8000.0):
    """speechbrain-style triangular filterbank [n_fft//2+1, n_mels].

    speechbrain's Filterbank builds SYMMETRIC triangles: filter m is centered
    at hz[m+1] with HALF-WIDTH band[m] = hz[m+1]-hz[m] on BOTH sides (the
    left mel gap), peak 1.0, no area normalization — distinct from the
    classic asymmetric HTK triangle and from librosa's slaney filters.
    """

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    all_freqs = np.linspace(0.0, sr // 2, n_fft // 2 + 1)
    hz = mel_to_hz(np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2))
    f_central = hz[1:-1]  # [n_mels]
    band = (hz[1:] - hz[:-1])[:n_mels]  # left gap per filter
    slope = (all_freqs[None, :] - f_central[:, None]) / band[:, None]
    fb = np.maximum(0.0, np.minimum(slope + 1.0, 1.0 - slope))
    return fb.T.astype(np.float32)  # [freq, n_mels]


@lru_cache(maxsize=8)
def _mel_tensor(n_mels: int, device: torch.device) -> torch.Tensor:
    """The filterbank on ``device``, copied there once (a copy from pageable
    host memory would wait for the device's queue on every call)."""
    return torch.from_numpy(_mel_matrix(n_mels)).to(device)


ECAPA_HOP = 160


def frame_mask(n_frames: int, lengths: torch.Tensor | None) -> torch.Tensor | None:
    """[B, 1, n_frames] validity mask from sample lengths (None = all valid)."""
    if lengths is None:
        return None
    valid = torch.clamp(1 + lengths // ECAPA_HOP, max=n_frames)  # frames per row
    return (torch.arange(n_frames, device=lengths.device)[None, :] < valid[:, None])[:, None, :]


def _masked_mean(x, mask, dim=-1, eps=1e-12):
    if mask is None:
        return x.mean(dim=dim, keepdim=True)
    m = mask.to(x.dtype)
    return (x * m).sum(dim=dim, keepdim=True) / m.sum(dim=dim, keepdim=True).clamp_min(eps)


def log_mel_fbank(
    wav: torch.Tensor, n_mels: int = 80, top_db: float = 80.0,
    lengths: torch.Tensor | None = None,
) -> torch.Tensor:
    """[B, T] @16k -> [B, 1+T//hop, n_mels] log-mel features, mean-normed.

    Reproduces the speechbrain Fbank -> InputNormalization(sentence, no std)
    chain the reference's EncoderClassifier runs before the ECAPA net:
    centered STFT (constant pad, periodic hamming window, 25 ms / 10 ms),
    power spectrum, symmetric mel triangles, 10*log10 with amin=1e-10,
    per-utterance top_db clamp over every frame (padding included), then
    sentence-level mean subtraction over the VALID frames only.
    """
    win, hop = 400, ECAPA_HOP
    n_frames = 1 + wav.shape[1] // hop
    frames = F.pad(wav, (win // 2, win // 2)).unfold(-1, win, hop)  # [B, n_frames, win]
    window = torch.hamming_window(win, periodic=True, dtype=wav.dtype, device=wav.device)
    spec = torch.fft.rfft(frames * window, n=win, dim=-1)
    power = spec.real**2 + spec.imag**2
    mel = power @ _mel_tensor(n_mels, wav.device)
    logmel = 10.0 * torch.log10(mel.clamp_min(1e-10))
    logmel = torch.maximum(logmel, logmel.amax(dim=(1, 2), keepdim=True) - top_db)
    mask = frame_mask(n_frames, lengths)
    return logmel - _masked_mean(logmel, None if mask is None else mask.transpose(1, 2), dim=1)


# ---------------------------------------------------------------------------
# blocks, under speechbrain's module names
# ---------------------------------------------------------------------------


class _Conv(nn.Module):
    """speechbrain's Conv1d wrapper (the ``nn.Conv1d`` is its ``conv`` child),
    zero-padded to 'same'."""

    def __init__(self, cin, cout, k=1, dilation=1):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k, dilation=dilation, padding=(k - 1) * dilation // 2)

    def forward(self, x):
        return self.conv(x)


class _BN(nn.Module):
    """speechbrain's BatchNorm1d wrapper (``norm`` child); always on the
    running statistics, whatever the module's mode."""

    def __init__(self, c):
        super().__init__()
        self.norm = nn.BatchNorm1d(c, eps=1e-5)

    def forward(self, x):
        n = self.norm
        return F.batch_norm(x, n.running_mean, n.running_var, n.weight, n.bias, training=False, eps=n.eps)


class _TDNN(nn.Module):
    """conv -> ReLU -> BatchNorm (speechbrain's TDNNBlock)."""

    def __init__(self, cin, cout, k=1, dilation=1):
        super().__init__()
        self.conv = _Conv(cin, cout, k, dilation)
        self.norm = _BN(cout)

    def forward(self, x):
        return self.norm(F.relu(self.conv(x)))


class _Res2Net(nn.Module):
    def __init__(self, c, scale, k, dilation):
        super().__init__()
        h = c // scale
        self.scale = scale
        self.blocks = nn.ModuleList(_TDNN(h, h, k, dilation) for _ in range(scale - 1))

    def forward(self, x):
        chunks = x.chunk(self.scale, dim=1)
        outs, y = [chunks[0]], None
        for i, block in enumerate(self.blocks):
            y = block(chunks[i + 1] if y is None else chunks[i + 1] + y)
            outs.append(y)
        return torch.cat(outs, dim=1)


class _SE(nn.Module):
    def __init__(self, c, se_channels):
        super().__init__()
        self.conv1 = _Conv(c, se_channels)
        self.conv2 = _Conv(se_channels, c)

    def forward(self, x, mask=None):
        s = _masked_mean(x, mask)  # [B, C, 1] over valid frames (speechbrain SE)
        return x * torch.sigmoid(self.conv2(F.relu(self.conv1(s))))


class _SERes2Net(nn.Module):
    def __init__(self, c, scale, dilation, se_channels):
        super().__init__()
        self.tdnn1 = _TDNN(c, c)
        self.res2net_block = _Res2Net(c, scale, 3, dilation)
        self.tdnn2 = _TDNN(c, c)
        self.se_block = _SE(c, se_channels)

    def forward(self, x, mask=None):
        return self.se_block(self.tdnn2(self.res2net_block(self.tdnn1(x))), mask) + x


class _ASP(nn.Module):
    """Attentive statistics pooling with global context (speechbrain's
    AttentiveStatisticsPooling, eps 1e-12): time stats, TDNN -> tanh -> conv
    attention, softmax over the valid frames, weighted mean and std."""

    def __init__(self, c, attention_channels):
        super().__init__()
        self.tdnn = _TDNN(3 * c, attention_channels)
        self.conv = _Conv(attention_channels, c)

    def forward(self, x, mask=None, eps=1e-12):
        mean = _masked_mean(x, mask)
        std = _masked_mean((x - mean) ** 2, mask).clamp_min(eps).sqrt()
        glob = torch.cat([x, mean.expand_as(x), std.expand_as(x)], dim=1)
        a = self.conv(torch.tanh(self.tdnn(glob)))  # [B, C, T]
        if mask is not None:
            a = a.masked_fill(~mask, -math.inf)
        a = torch.softmax(a, dim=2)
        mu = (a * x).sum(dim=2)
        sg = ((a * x * x).sum(dim=2) - mu * mu).clamp_min(eps).sqrt()
        return torch.cat([mu, sg], dim=1)  # [B, 2C]


class EcapaTDNN(nn.Module):
    """wav [B, T] @16k (+ per-row valid sample counts) -> [B, emb].

    Built with random weights drawn from ``generator`` (the distribution of
    the JAX package's ``random_ecapa_params``: conv weights N(0, 1/(k·cin)),
    SE weights · 0.03, the attention conv's · 0.05, the final projection's ·
    0.01, zero biases, identity BatchNorm); real use loads the released
    checkpoint over them (:func:`ecapa_from_state_dict`)."""

    def __init__(self, channels: int = 1024, n_mels: int = 80, emb: int = 192, scale: int = 8,
                 attention_channels: int = 128, se_channels: int = 128,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n_mels = n_mels
        self.blocks = nn.ModuleList(
            [_TDNN(n_mels, channels, 5)]
            + [_SERes2Net(channels, scale, dilation, se_channels) for dilation in (2, 3, 4)])
        cat = 3 * channels
        self.mfa = _TDNN(cat, cat)  # a full TDNN block: conv + ReLU + BN
        self.asp = _ASP(cat, attention_channels)
        self.asp_bn = _BN(2 * cat)
        self.fc = _Conv(2 * cat, emb)
        self._init(generator if generator is not None else torch.Generator().manual_seed(0))

    @torch.no_grad()
    def _init(self, gen):
        scaled = {id(m.conv): s for blk in self.blocks[1:] for m, s in
                  ((blk.se_block.conv1, 0.03), (blk.se_block.conv2, 0.03))}
        scaled.update({id(self.asp.conv.conv): 0.05, id(self.fc.conv): 0.01})
        for m in self.modules():
            if isinstance(m, nn.Conv1d):
                cout, cin, k = m.weight.shape
                s = scaled.get(id(m), 1 / math.sqrt(k * cin))
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * s)
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm1d):
                m.reset_parameters()

    def forward(self, wav: torch.Tensor, lengths: torch.Tensor | None = None) -> torch.Tensor:
        """``lengths`` mirrors the reference's ``encode_batch(..., wav_lens=...)``:
        zero-padded tails are left out of the fbank mean-norm, the SE means and
        the pooling, so an utterance's embedding does not depend on its padding."""
        feats = log_mel_fbank(wav, self.n_mels, lengths=lengths)  # [B, F, n_mels]
        mask = frame_mask(feats.shape[1], lengths)
        x = self.blocks[0](feats.transpose(1, 2))
        outs = []
        for block in self.blocks[1:]:
            x = block(x, mask)
            outs.append(x)
        x = self.mfa(torch.cat(outs, dim=1))  # MFA concat [B, 3072, F]
        x = self.asp_bn(self.asp(x, mask))
        return self.fc(x[:, :, None])[:, :, 0]


def ecapa_from_state_dict(sd: dict) -> EcapaTDNN:
    """An ``EcapaTDNN`` holding a speechbrain ECAPA state dict (the released
    ``embedding_model.ckpt``), its widths read from the tensors' shapes;
    loaded strictly on the state dict's device."""
    channels, n_mels, _ = sd["blocks.0.conv.conv.weight"].shape
    hidden = sd["blocks.1.res2net_block.blocks.0.conv.conv.weight"].shape[0]
    model = EcapaTDNN(
        channels=channels, n_mels=n_mels, emb=sd["fc.conv.weight"].shape[0], scale=channels // hidden,
        attention_channels=sd["asp.tdnn.conv.conv.weight"].shape[0],
        se_channels=sd["blocks.1.se_block.conv1.conv.weight"].shape[0])
    model.to(sd["fc.conv.weight"].device).load_state_dict(sd, strict=True)
    return model


class EcapaEncoder:
    """Frozen ECAPA on one device: wav [B, T] @16k, lengths -> [B, 1, emb].

    From a speechbrain ``.ckpt`` path (loaded onto ``device``, the card unless
    ``device="cpu"``) or from a module (moved there)."""

    is_stub = False

    def __init__(self, weights_path: str | None = None, module: EcapaTDNN | None = None, device=None):
        self.device = resolve_device(device)
        if module is None:
            module = ecapa_from_state_dict(torch.load(weights_path, map_location=self.device, weights_only=True))
        self.module = module.to(self.device).eval().requires_grad_(False)

    @torch.no_grad()
    def __call__(self, wav, lengths=None) -> torch.Tensor:
        wav = torch.as_tensor(wav).to(self.device, torch.float32)
        if lengths is not None:
            lengths = torch.as_tensor(lengths).to(self.device)
        return self.module(wav, lengths)[:, None, :]
