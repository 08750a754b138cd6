"""Whisper (base) ASR in PyTorch: the cascaded path's transcriber.

Port of ``cse_tpu/models/whisper.py``. The reference's cascaded pipeline
transcribes each separated stream with
``whisper.load_model("base").transcribe(...)`` (``test_cascaded.py:116,224``).
The published architecture (Radford et al. 2022):

  log-mel(80) -> Conv1d(k3,s1)+GELU -> Conv1d(k3,s2)+GELU -> +sin pos
  -> N pre-LN encoder layers -> LN
  decoder: tok emb + learned pos -> N pre-LN layers (causal self-attn +
  cross-attn) -> LN -> logits = emb^T

The module tree carries OpenAI's state-dict key names (``encoder.conv1``,
``encoder.blocks.N.attn.query`` / ``key`` / ``value`` / ``out``,
``attn_ln``, ``mlp.0`` / ``mlp.2``, ``mlp_ln``, ``encoder.ln_post``,
``decoder.token_embedding``, ``decoder.positional_embedding``,
``cross_attn``, ``cross_attn_ln``, ``decoder.ln``), so a released ``base.pt``
``model_state_dict`` loads strictly with no remap. Its
``encoder.positional_embedding`` is kept as a buffer for that load only: the
forward adds the sinusoid table it computes itself (:func:`_sinusoids`), as
the JAX package does. Weights are fp32 and frozen. Attention scales both q
and k by ``hd ** -0.25`` and takes an fp32 softmax; ``key`` has no bias.

Decoding runs one decoder step at a time from Python over a preallocated KV
cache ``[n_layer, B, n_text_ctx, D]`` written in place at the step's slot,
with JAX's semantics: the prompt is fed one token a step through the same
step, ``<|nospeech|>`` is read at the SOT slot, ``sum_logprob`` counts the
terminating EOT, ``steps = min(max_tokens, n_text_ctx - P)``, the tail is
EOT and lengths come from the first EOT. JAX's ``while_loop`` stops once
every row is done; steps after that change nothing, so the host reads
``done.all()`` only every ``sync_every`` sampled steps. The whole
``whisper.transcribe`` default policy sits on top (:class:`WhisperASR`):
timestamp rules, the temperature ladder with ``best_of``, the silence skip,
language detection, the long-form seek loop and previous-text prompts.

Sampled rungs take ``argmax(logits / T + g)`` with Gumbel noise ``g`` from a
``noise(step, shape)`` callable; by default a ``torch.Generator`` seeded
from ``seed`` draws it. JAX draws its noise from ``jax.random``, so the
sampled rungs of the two packages draw other noise unless the caller feeds
JAX's draws in (the tests do). Everything runs on the card unless the caller
asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cse_tpu_torch.core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    n_vocab: int = 51865
    n_audio_ctx: int = 1500
    n_audio_state: int = 512
    n_audio_head: int = 8
    n_audio_layer: int = 6
    n_text_ctx: int = 448
    n_text_state: int = 512
    n_text_head: int = 8
    n_text_layer: int = 6

    # special tokens (multilingual vocab)
    @property
    def sot(self):
        return 50258

    @property
    def eot(self):
        return 50257

    @property
    def token_transcribe(self):
        return 50359

    @property
    def token_translate(self):
        return 50358

    @property
    def token_sot_lm(self):
        return 50360

    @property
    def token_sot_prev(self):
        return 50361

    @property
    def token_nospeech(self):
        return 50362

    @property
    def token_notimestamps(self):
        return 50363

    @property
    def timestamp_begin(self):
        return 50364

    @property
    def token_lang_en(self):
        return 50259


# ---- audio frontend -------------------------------------------------------

_WHISPER_N_FFT, _WHISPER_HOP = 400, 160


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(
        f >= min_log_hz,
        min_log_hz / f_sp + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
        f / f_sp,
    )


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        m >= min_log_mel,
        min_log_hz * np.exp(logstep * (m - min_log_mel)),
        f_sp * m,
    )


@lru_cache(maxsize=4)
def mel_filters_slaney(n_mels: int = 80, n_fft: int = 400, sr: int = 16000) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangular mel filterbank
    [n_fft//2+1, n_mels]: ``librosa.filters.mel(sr=16000, n_fft=400,
    n_mels=80)``, the matrix OpenAI whisper ships in ``mel_filters.npz``."""
    fft_freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_pts = _mel_to_hz_slaney(
        np.linspace(_hz_to_mel_slaney(0.0), _hz_to_mel_slaney(sr / 2.0), n_mels + 2)
    )
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # slaney area norm: each filter integrates to ~2/bandwidth
    weights *= (2.0 / (mel_pts[2:] - mel_pts[:-2]))[:, None]
    return weights.T.astype(np.float32)


@lru_cache(maxsize=8)
def _frontend_tensors(n_mels: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The periodic Hann window and the mel filterbank on ``device``, copied
    there once."""
    window = torch.from_numpy(np.hanning(_WHISPER_N_FFT + 1)[:-1].astype(np.float32)).to(device)
    filters = torch.from_numpy(mel_filters_slaney(n_mels, _WHISPER_N_FFT, 16000)).to(device)
    return window, filters


def whisper_log_mel(wav: torch.Tensor, n_mels: int = 80, n_frames: int = 3000) -> torch.Tensor:
    """[B, T]@16k (padded or trimmed to ``n_frames`` hops) -> [B, n_frames, n_mels].

    Whisper's front end: pad or trim, a reflect pad of n_fft/2, frames of
    the periodic Hann window every hop (frames 0..n_frames-1: whisper drops
    torch.stft(center=True)'s last), the power spectrum, the slaney mel,
    log10, a per-utterance clamp at the maximum minus 8, then (x + 4) / 4."""
    T = n_frames * _WHISPER_HOP
    wav = wav.float()[:, :T]
    wav = F.pad(wav, (0, max(0, T - wav.shape[1])))
    half = _WHISPER_N_FFT // 2
    wav = F.pad(wav[:, None], (half, half), mode="reflect")[:, 0]
    frames = wav.unfold(-1, _WHISPER_N_FFT, _WHISPER_HOP)[:, :n_frames]
    window, filters = _frontend_tensors(n_mels, wav.device)
    spec = torch.fft.rfft(frames * window, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    log_spec = torch.log10(torch.clamp_min(power @ filters, 1e-10))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (log_spec + 4.0) / 4.0


# ---- the network ----------------------------------------------------------


def _sinusoids(length: int, channels: int) -> np.ndarray:
    log_timescale = math.log(10000) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


@lru_cache(maxsize=8)
def _sinusoid_table(length: int, channels: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_sinusoids(length, channels)).to(device)


class MultiHeadAttention(nn.Module):
    def __init__(self, d: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d, bias=False)
        self.value = nn.Linear(d, d)
        self.out = nn.Linear(d, d)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, d: int, n_head: int, cross: bool = False):
        super().__init__()
        self.attn = MultiHeadAttention(d, n_head)
        self.attn_ln = nn.LayerNorm(d)
        if cross:
            self.cross_attn = MultiHeadAttention(d, n_head)
            self.cross_attn_ln = nn.LayerNorm(d)
        self.mlp = nn.Sequential(nn.Linear(d, 4 * d), nn.GELU(), nn.Linear(4 * d, d))
        self.mlp_ln = nn.LayerNorm(d)


class AudioEncoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        D = cfg.n_audio_state
        self.conv1 = nn.Conv1d(cfg.n_mels, D, 3, padding=1)
        self.conv2 = nn.Conv1d(D, D, 3, stride=2, padding=1)
        # OpenAI's file holds the table; the forward computes its own (module docstring)
        self.register_buffer("positional_embedding", torch.from_numpy(_sinusoids(cfg.n_audio_ctx, D)))
        self.blocks = nn.ModuleList([ResidualAttentionBlock(D, cfg.n_audio_head) for _ in range(cfg.n_audio_layer)])
        self.ln_post = nn.LayerNorm(D)


class TextDecoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        D = cfg.n_text_state
        self.token_embedding = nn.Embedding(cfg.n_vocab, D)
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.n_text_ctx, D))
        self.blocks = nn.ModuleList(
            [ResidualAttentionBlock(D, cfg.n_text_head, cross=True) for _ in range(cfg.n_text_layer)])
        self.ln = nn.LayerNorm(D)


class Whisper(nn.Module):
    """Whisper's weights under OpenAI's key names (fp32, frozen). The
    computation lives in the functions below, which take the module."""

    def __init__(self, cfg: WhisperConfig | None = None):
        super().__init__()
        self.cfg = cfg or WhisperConfig()
        self.encoder = AudioEncoder(self.cfg)
        self.decoder = TextDecoder(self.cfg)
        self.requires_grad_(False)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.decoder.positional_embedding.device


def _attn(q, k, v, n_head: int, bias=None):
    """Multi-head attention on projected q [B, Tq, D], k and v [B, Tk, D]:
    q and k both scaled by hd**-0.25, fp32 scores plus ``bias``, fp32
    softmax. JAX's ``_attn`` and ``_attn_cached`` are this one function."""
    B, Tq, D = q.shape
    Tk = k.shape[1]
    hd = D // n_head
    scale = hd ** -0.25
    q = q.reshape(B, Tq, n_head, hd).transpose(1, 2) * scale
    k = k.reshape(B, Tk, n_head, hd).transpose(1, 2) * scale
    v = v.reshape(B, Tk, n_head, hd).transpose(1, 2)
    logits = (q @ k.transpose(-1, -2)).float()
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return (probs @ v).transpose(1, 2).reshape(B, Tq, D)


def _mha(x, attn: MultiHeadAttention, kv=None, bias=None):
    src = x if kv is None else kv
    out = _attn(attn.query(x), attn.key(src), attn.value(src), attn.n_head, bias)
    return attn.out(out)


@torch.no_grad()
def whisper_encode(model: Whisper, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, 2 * n_audio_ctx, n_mels] -> audio features [B, n_audio_ctx, D]."""
    enc, cfg = model.encoder, model.cfg
    x = F.gelu(enc.conv1(mel.transpose(1, 2)))
    x = F.gelu(enc.conv2(x)).transpose(1, 2)
    x = x + _sinusoid_table(cfg.n_audio_ctx, cfg.n_audio_state, x.device)
    for blk in enc.blocks:
        x = x + _mha(blk.attn_ln(x), blk.attn)
        x = x + blk.mlp(blk.mlp_ln(x))
    return enc.ln_post(x)


@torch.no_grad()
def _cross_kv(model: Whisper, audio: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each decoder layer's cross-attention K and V of the audio features:
    two [n_text_layer, B, n_audio_ctx, D] tensors."""
    blocks = model.decoder.blocks
    return (torch.stack([blk.cross_attn.key(audio) for blk in blocks]),
            torch.stack([blk.cross_attn.value(audio) for blk in blocks]))


def new_kv_cache(model: Whisper, B: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The decoder's self-attention cache: K and V [n_text_layer, B, n_text_ctx, D], zeros."""
    cfg = model.cfg
    shape = (cfg.n_text_layer, B, cfg.n_text_ctx, cfg.n_text_state)
    dev = device or model.device
    return torch.zeros(shape, device=dev), torch.zeros(shape, device=dev)


@torch.no_grad()
def _decoder_step(model: Whisper, tokens: torch.Tensor, pos: int, kv_cache, audio_kv, offset=None) -> torch.Tensor:
    """One decoder position with cached self-attention K/V.

    tokens [B] at cache slot ``pos``; ``kv_cache`` (K, V) from
    :func:`new_kv_cache`, written in place at slot ``pos``; ``audio_kv`` from
    :func:`_cross_kv`. Returns the logits [B, V] (fp32).

    ``offset`` [B] (optional) carries right-aligned prompts of per-row
    length: row b's first real token lives at slot ``offset[b]``, its
    position embedding is ``pos - offset[b]`` (clamped at 0 for the pad
    slots, whose K/V stay masked), and slots below the offset never become
    visible. The mask is a finite -1e30 bias."""
    cfg, dec = model.cfg, model.decoder
    emb_pos = pos if offset is None else (pos - offset).clamp_min(0)
    x = (dec.token_embedding.weight[tokens] + dec.positional_embedding[emb_pos])[:, None]  # [B, 1, D]
    slots = torch.arange(cfg.n_text_ctx, device=x.device)
    mask = (slots <= pos)[None, :]
    if offset is not None:
        mask = mask & (slots[None, :] >= offset[:, None])
    bias = torch.where(mask, 0.0, -1e30).float()[:, None, None, :]
    k_cache, v_cache = kv_cache
    ak, av = audio_kv
    H = cfg.n_text_head
    for li, blk in enumerate(dec.blocks):
        h = blk.attn_ln(x)
        q = blk.attn.query(h)
        k_cache[li, :, pos] = blk.attn.key(h)[:, 0]
        v_cache[li, :, pos] = blk.attn.value(h)[:, 0]
        x = x + blk.attn.out(_attn(q, k_cache[li], v_cache[li], H, bias))
        qc = blk.cross_attn.query(blk.cross_attn_ln(x))
        x = x + blk.cross_attn.out(_attn(qc, ak[li], av[li], H))
        x = x + blk.mlp(blk.mlp_ln(x))
    x = dec.ln(x)
    return (x[:, 0] @ dec.token_embedding.weight.t()).float()


# GPT-2-family single-token encoding of " ": whisper's SuppressBlank bars it
# (alongside EOT) at the first content position.
_SPACE_TOKEN = 220
# whisper multilingual tokenizers carry 99 language tokens, contiguous from
# <|en|> (50259) up to (but excluding) <|translate|> (50358)
_N_LANGUAGES = 99
# whisper.transcribe's max_initial_timestamp=1.0 s at 0.02 s/token precision
MAX_INITIAL_TIMESTAMP_INDEX = 50


def _suppress_masks(cfg: WhisperConfig, suppress_ids: tuple, timestamps: bool = False, device=None):
    """(never_mask, first_mask) [V] fp32 on ``device``: whisper's
    SuppressTokens (control tokens and the caller's non-speech set) and
    SuppressBlank (the space token and EOT barred at the first content
    position). ``timestamps=False`` also bars the whole timestamp range."""
    never = np.zeros(cfg.n_vocab, np.float32)
    control = [cfg.sot, cfg.token_translate, cfg.token_transcribe,
               cfg.token_sot_lm, cfg.token_sot_prev, cfg.token_nospeech,
               cfg.token_notimestamps]
    never[[t for t in control if t < cfg.n_vocab]] = -np.inf
    if not timestamps and cfg.timestamp_begin < cfg.n_vocab:
        never[cfg.timestamp_begin:] = -np.inf
    for t in suppress_ids:
        if 0 <= t < cfg.n_vocab:
            never[t] = -np.inf
    first = np.zeros(cfg.n_vocab, np.float32)
    first[cfg.eot] = -np.inf
    if _SPACE_TOKEN < cfg.n_vocab:
        first[_SPACE_TOKEN] = -np.inf
    return torch.from_numpy(never).to(device), torch.from_numpy(first).to(device)


def gumbel_noise(seed: int, device) -> callable:
    """The default noise of sampled rungs: ``(step, shape) -> -log(-log(u))``
    with u uniform in [tiny, 1), drawn from one generator seeded from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    tiny = torch.finfo(torch.float32).tiny

    def draw(step: int, shape) -> torch.Tensor:
        u = torch.rand(shape, generator=gen, device=device).clamp_min(tiny)
        return -torch.log(-torch.log(u))

    return draw


def _timestamp_rules(logits, s: int, tok, out, ts_last, has_ts, cfg: WhisperConfig, vocab_ids):
    """whisper's ApplyTimestampRules as vector masks. ``s`` is the number of
    tokens sampled so far; ``tok`` the latest one (when s >= 1) and
    ``out[:, s - 2]`` the one before. A sequence shorter than 2 counts its
    penultimate slot as a timestamp, as upstream's ``len(seq) < 2 or
    seq[-2] >= timestamp_begin``."""
    tb = cfg.timestamp_begin
    neg = float("-inf")
    is_ts_col = vocab_ids >= tb  # [V]
    B = logits.shape[0]
    last_was_ts = (tok >= tb) if s >= 1 else torch.zeros(B, dtype=torch.bool, device=logits.device)
    pen_was_ts = (out[:, s - 2] >= tb) if s >= 2 else torch.ones(B, dtype=torch.bool, device=logits.device)
    # pairing: after a closed pair the next token is text; after a lone
    # timestamp only a timestamp or EOT may follow
    logits = logits.masked_fill((last_was_ts & pen_was_ts)[:, None] & is_ts_col, neg)
    logits = logits.masked_fill((last_was_ts & ~pen_was_ts)[:, None] & (vocab_ids < cfg.eot), neg)
    # monotonic: bar timestamps below the last one (equal allowed only when closing a pair)
    bound = torch.where(last_was_ts & ~pen_was_ts, ts_last, ts_last + 1)
    logits = logits.masked_fill(has_ts[:, None] & is_ts_col & (vocab_ids[None, :] < bound[:, None]), neg)
    if s == 0:  # first sampled position: timestamps only, capped at 1.0 s
        logits = logits.masked_fill(~is_ts_col | (vocab_ids > tb + MAX_INITIAL_TIMESTAMP_INDEX), neg)
    # if the timestamps' total probability beats every text token, force one
    lp = torch.log_softmax(logits, dim=-1)
    ts_lp = torch.logsumexp(lp.masked_fill(~is_ts_col, neg), dim=-1)
    max_text_lp = lp.masked_fill(is_ts_col, neg).amax(dim=-1)
    return logits.masked_fill((ts_lp > max_text_lp)[:, None] & ~is_ts_col, neg)


@torch.no_grad()
def whisper_decode_audio(
    model: Whisper,
    audio: torch.Tensor,
    language_tokens: torch.Tensor,
    temperature: float = 0.0,
    seed: int = 0,
    max_tokens: int = 224,
    suppress_ids: tuple = (),
    timestamps: bool = False,
    prev_budget: int = 0,
    prev_tokens: torch.Tensor | None = None,
    prev_lens: torch.Tensor | None = None,
    noise=None,
    sync_every: int = 8,
):
    """One decode pass at ``temperature`` over pre-encoded audio features
    [B, n_audio_ctx, D] (:func:`whisper_encode`).

    ``timestamps=False``: prompt [SOT, lang, transcribe, notimestamps], the
    timestamp range suppressed. ``timestamps=True`` (``whisper.transcribe``'s
    default): prompt [SOT, lang, transcribe] and the timestamp rules applied
    each step. ``temperature == 0`` takes the argmax; above 0 the argmax of
    logits / T plus Gumbel noise from ``noise(step, shape)`` (default:
    :func:`gumbel_noise` of ``seed``), ``step`` being the loop index.

    Returns (tokens [B, max_tokens] int32, lengths [B], sum_logprob [B],
    no_speech_prob [B]): ``sum_logprob`` sums log-softmax(filtered
    logits)[chosen] over the sampled tokens including the terminating EOT;
    ``no_speech_prob`` is softmax(raw logits at the SOT slot)[<|nospeech|>].

    ``prev_budget > 0`` conditions on previous text: the prompt becomes
    [<|startofprev|>, prev..., SOT, lang, transcribe(, notimestamps)], with
    ``prev_tokens`` [B, prev_budget] right-aligned and ``prev_lens`` [B] their
    counts (<= prev_budget - 1); the pad slots stay masked and each row's
    positions start at 0 from its own <|startofprev|>. A row with
    ``prev_lens == 0`` sees no prefix at all."""
    cfg = model.cfg
    dev = audio.device
    B = audio.shape[0]
    never_mask, first_mask = _suppress_masks(cfg, suppress_ids, timestamps, dev)
    audio_kv = _cross_kv(model, audio)
    cols = [torch.full((B,), cfg.sot, device=dev), language_tokens.to(dev).long(),
            torch.full((B,), cfg.token_transcribe, device=dev)]
    if not timestamps:
        cols.append(torch.full((B,), cfg.token_notimestamps, device=dev))
    base = torch.stack(cols, dim=1)  # [B, base_P]
    if prev_budget > 0:
        prev_lens = prev_lens.to(dev).long()
        pcols = torch.arange(prev_budget, device=dev)
        # the filler cell just left of each row's real tokens doubles as its
        # <|startofprev|>; everything left of that stays masked
        prefix = torch.where(pcols[None, :] >= prev_budget - prev_lens[:, None],
                             prev_tokens.to(dev).long(), cfg.token_sot_prev)
        prompt = torch.cat([prefix, base], dim=1)
        offset = torch.where(prev_lens > 0, prev_budget - prev_lens - 1, prev_budget)
    else:
        prompt, offset = base, None
    P = prompt.shape[1]
    sot_slot = P - base.shape[1]  # where <|nospeech|> is read (SOT input)
    # upstream stops sampling at n_text_ctx; the cache never wraps
    steps = min(max_tokens, cfg.n_text_ctx - P)
    assert steps >= 1, f"prompt ({P}) leaves no sampling room in n_text_ctx ({cfg.n_text_ctx})"

    kv = new_kv_cache(model, B, dev)
    out = torch.full((B, max_tokens), cfg.eot, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    sum_lp = torch.zeros(B, device=dev)
    nsp = torch.zeros(B, device=dev)
    ts_last = torch.full((B,), cfg.timestamp_begin, dtype=torch.long, device=dev)
    has_ts = torch.zeros(B, dtype=torch.bool, device=dev)
    vocab_ids = torch.arange(cfg.n_vocab, device=dev)
    sampled = float(temperature) > 0
    if sampled:
        noise = noise or gumbel_noise(seed, dev)
        t_div = torch.full((), float(temperature), device=dev)  # a tensor: exact division on the card too
    tok = prompt[:, 0]
    for i in range(P + steps - 1):
        s = i + 1 - P  # tokens sampled so far
        if s >= sync_every and s % sync_every == 0 and bool(done.all()):
            break  # every row has stopped: later steps would change nothing
        raw = _decoder_step(model, tok, i, kv, audio_kv, offset=offset)
        if i == sot_slot:
            nsp = torch.softmax(raw, dim=-1)[:, cfg.token_nospeech]
        if s < 0:  # still feeding the prompt
            tok = prompt[:, i + 1]
            continue
        logits = raw + never_mask
        if s == 0:
            logits = logits + first_mask
        if timestamps:
            logits = _timestamp_rules(logits, s, tok, out, ts_last, has_ts, cfg, vocab_ids)
        if sampled:
            nxt = torch.argmax(logits / t_div + noise(i, tuple(logits.shape)).to(dev), dim=-1)
        else:
            nxt = torch.argmax(logits, dim=-1)
        take = ~done
        nxt = torch.where(done, cfg.eot, nxt)
        logp = torch.log_softmax(logits, dim=-1)
        sum_lp = sum_lp + torch.where(take, logp.gather(1, nxt[:, None])[:, 0], 0.0)
        out[:, s] = nxt
        done = done | (nxt == cfg.eot)
        new_ts = take & (nxt >= cfg.timestamp_begin)
        ts_last = torch.where(new_ts, nxt, ts_last)
        has_ts = has_ts | new_ts
        tok = nxt
    is_eot = out == cfg.eot
    lengths = torch.where(is_eot.any(dim=-1), is_eot.int().argmax(dim=-1), max_tokens)
    return out.int(), lengths, sum_lp, nsp


def whisper_decode(model: Whisper, mel: torch.Tensor, language_tokens: torch.Tensor, temperature: float = 0.0,
                   seed: int = 0, max_tokens: int = 224, suppress_ids: tuple = (), timestamps: bool = False,
                   noise=None):
    """Encode + one decode pass (:func:`whisper_encode` -> :func:`whisper_decode_audio`)."""
    audio = whisper_encode(model, mel)
    return whisper_decode_audio(model, audio, language_tokens, temperature, seed, max_tokens=max_tokens,
                                suppress_ids=suppress_ids, timestamps=timestamps, noise=noise)


def whisper_greedy_decode(model: Whisper, mel: torch.Tensor, max_tokens: int = 224,
                          language_token: int | None = None, suppress_ids: tuple = ()):
    """Greedy <|notimestamps|> transcription. Returns (tokens [B, max_tokens], lengths [B])."""
    cfg = model.cfg
    lang = cfg.token_lang_en if language_token is None else language_token
    toks, lens, _, _ = whisper_decode(model, mel, torch.full((mel.shape[0],), lang, device=mel.device),
                                      max_tokens=max_tokens, suppress_ids=suppress_ids)
    return toks, lens


def whisper_detect_language(model: Whisper, mel: torch.Tensor):
    """Encode + language detection (:func:`whisper_detect_language_audio`)."""
    return whisper_detect_language_audio(model, whisper_encode(model, mel))


@torch.no_grad()
def whisper_detect_language_audio(model: Whisper, audio: torch.Tensor):
    """whisper's ``detect_language`` over pre-encoded audio features: one
    decoder step on [SOT], logits restricted to the 99 language tokens.
    Returns (lang_token [B], probs [B, n_vocab]: the softmax over the
    restricted logits)."""
    cfg = model.cfg
    B = audio.shape[0]
    logits = _decoder_step(model, torch.full((B,), cfg.sot, device=audio.device), 0,
                           new_kv_cache(model, B, audio.device), _cross_kv(model, audio))
    mask = np.full(cfg.n_vocab, -np.inf, np.float32)
    mask[cfg.token_lang_en:min(cfg.token_lang_en + _N_LANGUAGES, cfg.n_vocab)] = 0.0
    logits = logits + torch.from_numpy(mask).to(audio.device)
    return torch.argmax(logits, dim=-1).int(), torch.softmax(logits, dim=-1)


# ---- weights --------------------------------------------------------------


def random_whisper_params(cfg: WhisperConfig, seed: int = 0) -> dict[str, torch.Tensor]:
    """Random weights as an OpenAI-layout state_dict (fp32 CPU tensors):
    the JAX package's ``random_whisper_params`` draws, the same numpy
    ``default_rng(seed)`` calls in the same order, so both packages' random
    Whisper of one seed is one function. Biases are zero and LayerNorms the
    identity, as there."""
    rng = np.random.default_rng(seed)
    D = cfg.n_audio_state
    sd: dict[str, np.ndarray] = {}

    def lin(name, din, dout, bias=True):
        sd[f"{name}.weight"] = (rng.standard_normal((din, dout)) / math.sqrt(din)).astype(np.float32).T
        if bias:
            sd[f"{name}.bias"] = np.zeros(dout, np.float32)

    def ln(name):
        sd[f"{name}.weight"] = np.ones(D, np.float32)
        sd[f"{name}.bias"] = np.zeros(D, np.float32)

    def attn(prefix):
        for part, bias in (("query", True), ("key", False), ("value", True), ("out", True)):
            lin(f"{prefix}.{part}", D, D, bias)

    def mlp(prefix):
        lin(f"{prefix}.0", D, 4 * D)
        lin(f"{prefix}.2", 4 * D, D)

    sd["encoder.conv1.weight"] = (rng.standard_normal((3, cfg.n_mels, D)) * 0.05).astype(np.float32).transpose(2, 1, 0)
    sd["encoder.conv1.bias"] = np.zeros(D, np.float32)
    sd["encoder.conv2.weight"] = (rng.standard_normal((3, D, D)) * 0.05).astype(np.float32).transpose(2, 1, 0)
    sd["encoder.conv2.bias"] = np.zeros(D, np.float32)
    for i in range(cfg.n_audio_layer):
        p = f"encoder.blocks.{i}"
        ln(f"{p}.attn_ln")
        attn(f"{p}.attn")
        ln(f"{p}.mlp_ln")
        mlp(f"{p}.mlp")
    ln("encoder.ln_post")
    sd["decoder.token_embedding.weight"] = (rng.standard_normal((cfg.n_vocab, D)) * 0.02).astype(np.float32)
    sd["decoder.positional_embedding"] = (rng.standard_normal((cfg.n_text_ctx, D)) * 0.02).astype(np.float32)
    for i in range(cfg.n_text_layer):
        p = f"decoder.blocks.{i}"
        ln(f"{p}.attn_ln")
        attn(f"{p}.attn")
        ln(f"{p}.cross_attn_ln")
        attn(f"{p}.cross_attn")
        ln(f"{p}.mlp_ln")
        mlp(f"{p}.mlp")
    ln("decoder.ln")
    sd["encoder.positional_embedding"] = _sinusoids(cfg.n_audio_ctx, D)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def whisper_from_state_dict(sd: dict, cfg: WhisperConfig | None = None, device=None) -> Whisper:
    """A :class:`Whisper` on ``device`` (the card unless ``device="cpu"``)
    with an OpenAI-layout state_dict loaded strictly: a missing or unexpected
    key, or a shape mismatch, raises."""
    model = Whisper(cfg)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()}, strict=True)
    return model.to(resolve_device(device))


def random_whisper(cfg: WhisperConfig | None = None, seed: int = 0, device=None) -> Whisper:
    """A :class:`Whisper` of :func:`random_whisper_params` on ``device``."""
    cfg = cfg or WhisperConfig()
    return whisper_from_state_dict(random_whisper_params(cfg, seed), cfg, device)


def load_whisper(path: str, cfg: WhisperConfig | None = None, device=None) -> Whisper:
    """OpenAI's ``base.pt`` (``{"dims", "model_state_dict"}``, or a bare
    state_dict) -> :class:`Whisper`. Without ``cfg`` the file's ``dims``
    give the widths (``WhisperConfig()`` when it has none)."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob["model_state_dict"] if "model_state_dict" in blob else blob
    if cfg is None:
        dims = blob.get("dims") if "model_state_dict" in blob else None
        cfg = WhisperConfig(**dims) if dims else WhisperConfig()
    return whisper_from_state_dict(sd, cfg, device)


# ---- transcribe policy (whisper.transcribe defaults) ----------------------

# whisper.transcribe's programmatic defaults, what the reference's option-free
# transcribe() call runs (test_cascaded.py:224): best_of=None resolves to one
# sample per t > 0 rung (DecodingTask: n_group = beam_size or best_of or 1)
TRANSCRIBE_TEMPERATURES = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
COMPRESSION_RATIO_THRESHOLD = 2.4
LOGPROB_THRESHOLD = -1.0
NO_SPEECH_THRESHOLD = 0.6
BEST_OF = 1


def compression_ratio(text: str) -> float:
    """whisper.utils.compression_ratio: utf-8 bytes / zlib-compressed bytes."""
    data = text.encode("utf-8")
    return len(data) / len(zlib.compress(data))


def needs_fallback(avg_logprob: float, cr: float, no_speech_prob: float) -> bool:
    """whisper.transcribe's retry gate: too repetitive (cr > 2.4) or too
    unlikely (avg lp < -1.0), unless the segment looks silent (nospeech
    prob > 0.6)."""
    fb = False
    if cr > COMPRESSION_RATIO_THRESHOLD:
        fb = True
    if avg_logprob < LOGPROB_THRESHOLD:
        fb = True
    if no_speech_prob > NO_SPEECH_THRESHOLD:
        fb = False
    return fb


def is_silent(avg_logprob: float, no_speech_prob: float) -> bool:
    """whisper.transcribe's segment skip: nospeech prob above threshold
    unless a confident logprob overrides it."""
    skip = no_speech_prob > NO_SPEECH_THRESHOLD
    if avg_logprob > LOGPROB_THRESHOLD:
        skip = False
    return skip


# seconds per mel frame (hop 160 @ 16 kHz) and per timestamp token (2 frames)
_FRAME_SECONDS = _WHISPER_HOP / 16000.0
_INPUT_STRIDE = 2
TIME_PRECISION = _FRAME_SECONDS * _INPUT_STRIDE  # 0.02 s


def parse_seek_window(tokens, silent: bool, seek: int, segment_size: int, cfg: WhisperConfig):
    """whisper.transcribe's per-window seek and segment logic. ``tokens`` is
    one window's sampled sequence, ``seek`` the window's start and
    ``segment_size`` its extent, both in mel frames. Returns
    ``(advance_frames, segments)``: a silent window is skipped whole; tokens
    are cut at every consecutive-timestamp pair into closed segments; a
    window ending in a lone timestamp closes its trailing piece and advances
    the full extent, otherwise the unfinished piece is dropped and the seek
    goes to the last closed segment's end; with no pair all tokens form one
    segment and the seek advances the full extent. Times are absolute
    seconds; a non-positive advance falls back to the full extent."""
    tb = cfg.timestamp_begin
    time_offset = seek * _FRAME_SECONDS
    if silent:
        return segment_size, []
    toks = [int(t) for t in tokens]
    is_ts = [t >= tb for t in toks]
    single_ending = len(toks) >= 2 and (not is_ts[-2]) and is_ts[-1]
    consecutive = [i + 1 for i in range(len(toks) - 1) if is_ts[i] and is_ts[i + 1]]
    segs = []
    if consecutive:
        slices = list(consecutive)
        if single_ending:
            slices.append(len(toks))
        last = 0
        for cur in slices:
            st = toks[last:cur]
            segs.append({
                "start": time_offset + (st[0] - tb) * TIME_PRECISION,
                "end": time_offset + (st[-1] - tb) * TIME_PRECISION,
                "tokens": np.asarray(st, np.int32),
            })
            last = cur
        if single_ending:
            advance = segment_size
        else:
            advance = (toks[last - 1] - tb) * _INPUT_STRIDE
    else:
        duration = segment_size * _FRAME_SECONDS
        ts = [t for t in toks if t >= tb]
        if ts and ts[-1] != tb:
            duration = (ts[-1] - tb) * TIME_PRECISION
        segs.append({
            "start": time_offset,
            "end": time_offset + duration,
            "tokens": np.asarray(toks, np.int32),
        })
        advance = segment_size
    if advance <= 0:
        advance = segment_size
    return advance, segs


class WhisperASR:
    """Batch transcriber: wav [B, T]@16k -> token ids / transcribe results.

    ``transcribe_tokens`` is one decode pass at temperature 0;
    ``transcribe_results`` runs the whole ``whisper.transcribe`` default
    policy (timestamped decoding, the temperature ladder with ``best_of``
    sampled candidates a rung, the silence skip, language detection, the
    seek loop with previous-text prompts). ``language=None`` detects it from
    each row's first window; ``without_timestamps=True`` pins
    <|notimestamps|>.

    The weights: ``model`` (a :class:`Whisper`), else ``weights_path`` (OpenAI's
    ``base.pt``), else :func:`random_whisper` of seed 0. ``precompile=True``
    runs :meth:`warmup` on the first ``transcribe_results`` call of each
    (batch, max_tokens) shape. Runs on ``device``: the card unless
    ``device="cpu"``."""

    def __init__(self, weights_path: str | None = None, cfg: WhisperConfig | None = None,
                 model: Whisper | None = None, suppress_ids: tuple = (),
                 language: str | None = "en", text_fn=None, seed: int = 0,
                 temperatures: tuple = TRANSCRIBE_TEMPERATURES,
                 best_of: int = BEST_OF, without_timestamps: bool = False,
                 condition_on_previous_text: bool = True,
                 precompile: bool = False, device=None):
        self.device = resolve_device(device)
        self.condition_on_previous_text = bool(condition_on_previous_text)
        self.timestamps = not without_timestamps
        self.suppress_ids = tuple(sorted(set(int(t) for t in suppress_ids)))
        if language not in (None, "en"):
            # only 'en' has a pinned prompt id here; refuse rather than decode with <|en|>
            raise ValueError(
                f"language={language!r} unsupported: pass 'en' or None "
                "(None auto-detects per row like whisper.transcribe)"
            )
        self.language = language
        self.text_fn = text_fn  # token ids -> text, for the compression ratio
        self.seed = seed
        self.temperatures = tuple(float(t) for t in temperatures)
        self.best_of = int(best_of)
        if model is None and weights_path is not None:
            model = load_whisper(weights_path, cfg, device="cpu")
        if model is None:
            model = random_whisper(cfg, device="cpu")
        self.model = model.to(self.device)
        self.cfg = self.model.cfg
        self.precompile = bool(precompile)
        self._warmed: set = set()

    def _decode(self, audio, lang, temperature, seed, max_tokens, **kw):
        return whisper_decode_audio(self.model, audio, lang, temperature, seed, max_tokens=max_tokens,
                                    suppress_ids=self.suppress_ids, timestamps=self.timestamps, **kw)

    def warmup(self, batch_size: int, max_tokens: int = 224) -> None:
        """Run every decode program ``transcribe_results`` can reach at this
        (batch, max_tokens) shape once on zero audio: the plain batch and the
        best_of-tiled one, each with and without a previous-text prompt, the
        encoder and (when detecting) the language step; so the first real
        mixture pays no first-use costs (allocations, library handles)."""
        cfg = self.cfg
        B = int(batch_size)
        key = (B, int(max_tokens))
        if key in self._warmed:
            return
        wav = torch.zeros((B, cfg.n_audio_ctx * 2 * _WHISPER_HOP), device=self.device)
        audio = whisper_encode(self.model, self._mel(wav))
        lang = self._language_for(audio)
        widths = [B]
        if any(t > 0 for t in self.temperatures) and self.best_of != 1:
            widths.append(B * self.best_of)
        K = cfg.n_text_ctx // 2
        for n in widths:
            a = audio if n == B else audio.repeat_interleave(self.best_of, dim=0)
            lg = lang if n == B else lang.repeat_interleave(self.best_of, dim=0)
            prev_variants = [{}]
            if self.condition_on_previous_text:
                prev_variants.append({"prev_budget": K, "prev_tokens": torch.zeros((n, K), dtype=torch.long),
                                      "prev_lens": torch.zeros((n,), dtype=torch.long)})
            for kw in prev_variants:
                self._decode(a, lg, 0.0, 0, max_tokens, **kw)[0].cpu()
        self._warmed.add(key)

    def _mel(self, wav16k: torch.Tensor) -> torch.Tensor:
        window = self.cfg.n_audio_ctx * 2 * _WHISPER_HOP
        if wav16k.shape[-1] > window:
            raise ValueError(
                f"input of {wav16k.shape[-1]} samples exceeds the "
                f"{window}-sample ({window / 16000:.0f} s) single-window "
                "decode this transcriber implements; the reference eval "
                "protocol only produces <=30 s utterances"
            )
        return whisper_log_mel(wav16k, self.cfg.n_mels, n_frames=self.cfg.n_audio_ctx * 2)

    def _language_for(self, audio: torch.Tensor) -> torch.Tensor:
        if self.language is None:
            return whisper_detect_language_audio(self.model, audio)[0]
        return torch.full((audio.shape[0],), self.cfg.token_lang_en, dtype=torch.int32, device=audio.device)

    def _wav(self, wav16k) -> torch.Tensor:
        return torch.as_tensor(wav16k, dtype=torch.float32).to(self.device)

    def transcribe_tokens(self, wav16k, max_tokens: int = 224):
        """One temperature-0 pass over one window a row: (tokens, lengths) as numpy."""
        audio = whisper_encode(self.model, self._mel(self._wav(wav16k)))
        toks, lens, _, _ = self._decode(audio, self._language_for(audio), 0.0, self.seed, max_tokens)
        return toks.cpu().numpy(), lens.cpu().numpy()

    def _text(self, ids) -> str:
        # text tokens only: upstream's tokenizer.decode drops specials and
        # timestamp ids (>= EOT) before the strip and the compression gate
        ids = np.asarray(ids)
        ids = ids[ids < self.cfg.eot]
        if self.text_fn is not None:
            return self.text_fn(ids).strip()
        # no tokenizer assets: a stable pseudo-text over ids keeps the
        # repetition structure zlib measures
        return " ".join(f"w{int(t)}" for t in ids)

    def transcribe_results(self, wav16k, max_tokens: int = 224):
        """The whole ``whisper.transcribe`` default policy over a batch of
        rows; every row runs the seek loop (:meth:`_transcribe_seek`). Returns
        a list of per-row dicts: ``tokens`` (np.int32, the segments' tokens),
        ``text`` (through ``text_fn`` when given), ``avg_logprob``,
        ``compression_ratio``, ``no_speech_prob``, ``temperature`` (the rung
        accepted), ``silent``, ``windows`` (per-seek results) and
        ``segments`` (absolute times)."""
        wav = self._wav(wav16k)
        if self.precompile:
            self.warmup(wav.shape[0], max_tokens)
        return self._transcribe_seek(wav, max_tokens)

    def _transcribe_seek(self, wav: torch.Tensor, max_tokens: int):
        """whisper.transcribe's long-form seek loop over a batch of rows.

        Each iteration decodes one 30 s window per active row from its seek
        (the whole temperature ladder), cuts it with
        :func:`parse_seek_window` and advances the row's seek. The language
        is resolved once, from the first window. Finished rows ride along in
        the batch (their decode is discarded). A window's ``tokens`` and
        ``text`` are its segments'; the raw sequence stays in
        ``decoded_tokens``. With ``condition_on_previous_text`` each window's
        prompt carries the accumulated segment tokens (cropped to
        ``n_text_ctx // 2 - 1``), reset after a rung hotter than 0.5."""
        cfg = self.cfg
        frames_w = cfg.n_audio_ctx * 2
        window = frames_w * _WHISPER_HOP
        B, T = wav.shape
        content_frames = -(-T // _WHISPER_HOP)
        seek = np.zeros(B, np.int64)
        # stall budget: past ~2x the no-overlap window count a row advances whole windows
        budget = 2 * (-(-content_frames // frames_w)) + 8
        n_win = np.zeros(B, np.int64)
        lang = None
        win_results: list[list[dict]] = [[] for _ in range(B)]
        segments: list[list[dict]] = [[] for _ in range(B)]
        K = cfg.n_text_ctx // 2  # 1 (<|startofprev|>) + upstream's crop
        prompt_toks: list[list[int]] = [[] for _ in range(B)]
        while (seek < content_frames).any():
            rows = torch.zeros((B, window), device=self.device)
            for b in range(B):
                chunk = wav[b, int(seek[b]) * _WHISPER_HOP:][:window]
                rows[b, : chunk.shape[0]] = chunk
            audio = whisper_encode(self.model, self._mel(rows))
            if lang is None:
                lang = self._language_for(audio)
            prev = None
            # all-empty prompts (always the first window) take the prompt-free decode
            if self.condition_on_previous_text and any(prompt_toks):
                pt = np.zeros((B, K), np.int64)
                pl = np.zeros(B, np.int64)
                for b in range(B):
                    tail = prompt_toks[b][-(K - 1):]
                    pl[b] = len(tail)
                    if tail:
                        pt[b, K - len(tail):] = tail
                prev = (torch.from_numpy(pt), torch.from_numpy(pl))
            res = self._decode_rungs(audio, lang, max_tokens, active_rows=seek < content_frames, prev=prev)
            for b in range(B):
                if seek[b] >= content_frames:
                    continue
                segment_size = min(frames_w, content_frames - int(seek[b]))
                r = dict(res[b], seek=int(seek[b]))
                advance, segs = parse_seek_window(r["tokens"], r["silent"], int(seek[b]), segment_size, cfg)
                n_win[b] += 1
                if n_win[b] > budget:
                    advance = segment_size
                # only bites on test configs whose window is shorter than the timestamp range
                advance = min(advance, segment_size)
                r["decoded_tokens"] = r["tokens"]
                r["tokens"] = np.concatenate([s["tokens"] for s in segs]) if segs else np.zeros(0, np.int32)
                if self.text_fn is not None:
                    r["text"] = self._text(r["tokens"])
                for s in segs:
                    s["text"] = self._text(s["tokens"])
                    s.update(temperature=r["temperature"], avg_logprob=r["avg_logprob"],
                             compression_ratio=r["compression_ratio"], no_speech_prob=r["no_speech_prob"])
                win_results[b].append(r)
                segments[b].extend(segs)
                seek[b] += advance
                # upstream: the prompt grows by the segment tokens, then a rung
                # hotter than prompt_reset_on_temperature=0.5 resets it
                prompt_toks[b].extend(int(t) for t in r["tokens"])
                if r["temperature"] > 0.5:
                    prompt_toks[b] = []
        out = []
        for b in range(B):
            merged = self._merge_windows(win_results[b])
            merged["segments"] = segments[b]
            out.append(merged)
        return out

    def _decode_rungs(self, audio: torch.Tensor, lang: torch.Tensor, max_tokens: int, active_rows=None,
                      prev=None) -> list[dict]:
        """The temperature ladder over pre-encoded audio features. Rows not
        in ``active_rows`` ride along but never gate retries (their results
        stay None). ``prev`` (``(prev_tokens [B, K], prev_lens [B])``) goes
        unchanged to every rung, as upstream keeps the prompt across a
        window's fallbacks."""
        B = audio.shape[0]
        audio_k = None  # best_of-tiled features, built on the first sampled rung

        def pkw(rep: int = 1):
            if prev is None:
                return {}
            pt, pl = prev
            if rep > 1:
                pt, pl = pt.repeat_interleave(rep, dim=0), pl.repeat_interleave(rep)
            return {"prev_budget": prev[0].shape[1], "prev_tokens": pt, "prev_lens": pl}

        results: list[dict | None] = [None] * B
        pending = list(range(B)) if active_rows is None else [b for b in range(B) if active_rows[b]]
        temperatures = self.temperatures
        for ti, t in enumerate(temperatures):
            if t == 0.0:
                out = self._decode(audio, lang, 0.0, self.seed, max_tokens, **pkw())
                toks, lens, slp, nsp = (x.cpu().numpy() for x in out)
            else:
                # best_of > 1: tile rows, sample, rank by sum_logprob / length
                # (MaximumLikelihoodRanker, length_penalty=None)
                k = self.best_of
                if audio_k is None:
                    audio_k = audio.repeat_interleave(k, dim=0)
                out = self._decode(audio_k, lang.repeat_interleave(k, dim=0), t, self.seed * 1000 + ti, max_tokens,
                                   **pkw(k))
                toks5, lens5, slp5, nsp5 = (x.cpu().numpy() for x in out)
                score = slp5 / np.maximum(lens5, 1)
                pick = score.reshape(B, k).argmax(axis=1) + np.arange(B) * k
                toks, lens, slp, nsp = toks5[pick], lens5[pick], slp5[pick], nsp5[pick]
            still = []
            for b in pending:
                n = int(lens[b])
                ids = toks[b, :n]
                avg_lp = float(slp[b]) / (n + 1)
                txt = self._text(ids)
                cr = compression_ratio(txt)
                results[b] = {
                    "tokens": ids,
                    "text": txt if self.text_fn is not None else None,
                    "avg_logprob": avg_lp,
                    "compression_ratio": cr,
                    "no_speech_prob": float(nsp[b]),
                    "temperature": t,
                    "silent": is_silent(avg_lp, float(nsp[b])),
                }
                if needs_fallback(avg_lp, cr, float(nsp[b])) and ti + 1 < len(temperatures):
                    still.append(b)
            pending = still
            if not pending:
                break
        return results

    def _merge_windows(self, rs: list[dict]) -> dict:
        """One long-form row's per-window results merged: tokens and text over
        the non-silent windows; ``avg_logprob`` from the per-window sums with
        whisper's (n+1) accounting on the decoded lengths; the compression
        ratio of the merged text; the least-silent window's nospeech prob;
        the hottest accepted rung; silent only when every window is."""
        if not rs:
            # zero-length audio: no windows at all
            return {
                "tokens": np.zeros(0, np.int32),
                "text": "" if self.text_fn is not None else None,
                "avg_logprob": 0.0,
                "compression_ratio": compression_ratio(""),
                "no_speech_prob": 1.0,
                "temperature": 0.0,
                "silent": True,
                "windows": [],
            }
        voiced = [r for r in rs if not r["silent"]]
        toks = np.concatenate([r["tokens"] for r in voiced]) if voiced else np.zeros(0, np.int32)
        n_dec = [len(r.get("decoded_tokens", r["tokens"])) for r in rs]
        n_total = sum(n_dec)
        sum_lp = sum(r["avg_logprob"] * (n + 1) for r, n in zip(rs, n_dec))
        text = None
        if self.text_fn is not None:
            text = " ".join(t for t in (r["text"] for r in voiced) if t)
        return {
            "tokens": toks,
            "text": text,
            "avg_logprob": sum_lp / (n_total + len(rs)),
            "compression_ratio": compression_ratio(text if text is not None else self._text(toks)),
            "no_speech_prob": min(r["no_speech_prob"] for r in rs),
            "temperature": max(r["temperature"] for r in rs),
            "silent": all(r["silent"] for r in rs),
            "windows": rs,
        }
