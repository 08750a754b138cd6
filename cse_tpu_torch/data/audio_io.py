"""Host-side audio file IO.

Replaces the reference's librosa/soundfile dependency
(``dataset_train_CSE.py:173,236``; ``train_ContSep.py:538-548``): WAV decode to
float32 (PCM16/24/32, float32), peak utilities, and PCM_16 writes. The port's
copy of ``cse_tpu/data/audio_io.py``: the native C++ decoder with a
thread-pool batch loader (:mod:`cse_tpu_torch.native.audio_native`) is used
when it builds; this module's pure Python reader is the fallback and the
reference for its behaviour.

Note: sample-rate conversion does NOT happen here — files are decoded at
native rate and resampled on device by cse_tpu_torch.ops.resample (the
reference resamples on the CPU in every DataLoader worker).
"""

from __future__ import annotations

import struct
import wave

import numpy as np


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Decode a WAV file -> (float32 mono waveform in [-1, 1], sample_rate).

    Handles PCM 16/24/32-bit and IEEE float32; multi-channel is averaged to
    mono (librosa.load(mono=True) behavior).
    """
    lib = native()
    if lib is not None:
        out = lib.read_wav(path)
        if out is not None:
            return out
    return _read_wav_py(path)


def native():
    """The native decoder module when its library builds and loads, else None
    (the build is tried once a process)."""
    from cse_tpu_torch.native import audio_native

    return audio_native if audio_native.available() else None


def _read_wav_py(path: str) -> tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        header = f.read(12)
        if len(header) < 12 or header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        fmt = None
        data = None
        while True:
            chunk = f.read(8)
            if len(chunk) < 8:
                break
            cid, size = chunk[:4], struct.unpack("<I", chunk[4:])[0]
            if cid == b"fmt ":
                fmt = f.read(size)
            elif cid == b"data":
                data = f.read(size)
            else:
                f.seek(size + (size & 1), 1)
            if fmt is not None and data is not None:
                break
    if fmt is None or data is None:
        raise ValueError(f"missing fmt/data chunk: {path}")
    audio_format, n_channels, sr, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
    if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack("<H", fmt[24:26])[0]
    # floor to complete frames: truncated files decode their valid prefix
    # instead of crashing (matches the native decoder's behavior)
    frame = n_channels * (bits // 8)
    if frame > 0 and len(data) % frame:
        data = data[: len(data) - (len(data) % frame)]
    if audio_format == 3 and bits == 32:
        x = np.frombuffer(data, dtype="<f4").astype(np.float32)
    elif audio_format == 1 and bits == 16:
        x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
    elif audio_format == 1 and bits == 32:
        x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
    elif audio_format == 1 and bits == 24:
        raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        x = (
            raw[:, 0].astype(np.int32)
            | (raw[:, 1].astype(np.int32) << 8)
            | (raw[:, 2].astype(np.int32) << 16)
        )
        x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"unsupported wav format {audio_format}/{bits}bit: {path}")
    if n_channels > 1:
        x = x.reshape(-1, n_channels).mean(axis=1)
    return np.ascontiguousarray(x), sr


def write_wav(path: str, x: np.ndarray, sr: int, subtype: str = "PCM_16"):
    """Write mono float32 waveform as PCM_16 (the reference's dump format)."""
    assert subtype == "PCM_16"
    x = np.asarray(x, np.float32)
    pcm = np.clip(x * 32768.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def peak_normalize_np(x: np.ndarray, target: float = 0.9) -> np.ndarray:
    peak = np.max(np.abs(x))
    return x * (target / max(peak, 1e-12))

