"""The port's native C++ audio runtime (cse_tpu_torch/native): the cases of
tests/test_native.py against the port's decoder (decode parity with the
Python reader at 1e-7, the write/read round trip, the batch loader, a missing
file, the rows scatter, the zero-tail contract, a data chunk before fmt), the
build's location, and the loaders on the native path against the Python
reader. Skips when g++ cannot build it."""

import ctypes
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

import cse_tpu_torch
from cse_tpu_torch.data import audio_io
from cse_tpu_torch.data.audio_io import _read_wav_py, write_wav
from cse_tpu_torch.native import audio_native

REPO = Path(cse_tpu_torch.__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def built():
    if not audio_native.available():
        pytest.skip("g++ could not build the native decoder")
    return True


def _make_wavs(tmp_path, rng, n=4, sr=16000):
    paths = []
    for i in range(n):
        x = rng.uniform(-0.8, 0.8, 4000 + i * 500).astype(np.float32)
        p = str(tmp_path / f"{i}.wav")
        write_wav(p, x, sr)
        paths.append(p)
    return paths


def test_native_read_matches_python(built, tmp_path, rng):
    paths = _make_wavs(tmp_path, rng, n=2)
    for p in paths:
        nx, nsr = audio_native.read_wav(p)
        px, psr = _read_wav_py(p)
        assert nsr == psr
        np.testing.assert_allclose(nx, px, atol=1e-7)
        x, sr = audio_io.read_wav(p)  # the port's reader takes the native path
        assert sr == psr and np.array_equal(x, nx)


def test_native_write_read_roundtrip(built, tmp_path, rng):
    x = rng.uniform(-0.9, 0.9, 5000).astype(np.float32)
    p = str(tmp_path / "rt.wav")
    assert audio_native.write_wav(p, x, 8000)
    y, sr = _read_wav_py(p)
    assert sr == 8000
    np.testing.assert_allclose(y, x, atol=1.0 / 32000)


def test_batch_load(built, tmp_path, rng):
    paths = _make_wavs(tmp_path, rng, n=6)
    buf = np.zeros((6, 4500), np.float32)
    lens, srs = audio_native.batch_load(paths, buf, peak_target=0.9, n_threads=3)
    assert (srs == 16000).all()
    assert lens.tolist() == [min(4000 + i * 500, 4500) for i in range(6)]
    for i in range(6):  # peak-normalized rows
        assert abs(np.abs(buf[i, : lens[i]]).max() - 0.9) < 1e-3
    assert np.all(buf[0, lens[0]:] == 0)  # zero padding beyond the length


def test_batch_load_missing_file(built, tmp_path, rng):
    paths = _make_wavs(tmp_path, rng, n=1) + [str(tmp_path / "nope.wav")]
    buf = np.zeros((2, 4000), np.float32)
    lens, srs = audio_native.batch_load(paths, buf)
    assert lens[0] > 0 and lens[1] == 0


def test_batch_load_rows_scatter(built, tmp_path, rng):
    """One call filling rows of several arrays matches the contiguous form
    file for file (lengths, samples, failure zeroing)."""
    paths = _make_wavs(tmp_path, rng, n=4) + [str(tmp_path / "nope.wav")]
    a = np.zeros((3, 6000), np.float32)  # rows 0, 2, 4 land here
    b = np.zeros((2, 6000), np.float32)  # rows 1, 3 land here
    views = [a[0], b[0], a[1], b[1], a[2]]
    lens, srs = audio_native.batch_load_rows(paths, views, peak_target=0.9, zero_tail=False)
    ref = np.zeros((5, 6000), np.float32)
    rlens, rsrs = audio_native.batch_load(paths, ref, peak_target=0.9)
    assert (lens == rlens).all() and (srs == rsrs).all()
    for i, v in enumerate(views):
        np.testing.assert_array_equal(v, ref[i], err_msg=f"row {i}")
    assert lens[4] == 0 and np.all(a[2] == 0)  # the failed row fully zeroed


def test_batch_load_zero_tail_contract(built, tmp_path, rng):
    """zero_tail=True scrubs past each decoded length in a dirty buffer;
    zero_tail=False leaves the tail, but failed rows are always zeroed; the
    decoded samples are the same either way."""
    paths = _make_wavs(tmp_path, rng, n=2) + [str(tmp_path / "nope.wav")]
    dirty = np.full((3, 5000), 7.0, np.float32)
    scrubbed = dirty.copy()
    lens, _ = audio_native.batch_load(paths, scrubbed, zero_tail=True)
    for i in range(2):
        assert np.all(scrubbed[i, lens[i]:] == 0)
    assert np.all(scrubbed[2] == 0)
    left = dirty.copy()
    lens3, _ = audio_native.batch_load(paths, left, zero_tail=False)
    assert (lens3 == lens).all()
    for i in range(2):
        np.testing.assert_array_equal(left[i, : lens[i]], scrubbed[i, : lens[i]])
        assert np.all(left[i, lens[i]:] == 7.0)
    assert np.all(left[2] == 0)


def test_wav_info_data_chunk_before_fmt(built, tmp_path):
    """A legal WAV with the data chunk ahead of fmt still probes and decodes."""
    sr, n = 8000, 1234
    pcm = np.zeros(n).astype("<i2").tobytes()
    body = b"data" + struct.pack("<I", len(pcm)) + pcm + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
    p = str(tmp_path / "data_first.wav")
    with open(p, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body)
    got_sr = ctypes.c_int32(0)
    assert audio_native._load().cse_wav_info(p.encode(), ctypes.byref(got_sr)) == n and got_sr.value == sr
    x, rsr = audio_native.read_wav(p)
    assert rsr == sr and len(x) == n


def test_build_lands_in_the_port_build_dir_only(built):
    """The library is built from the port's own source into
    cse_tpu_torch/_build/ (gitignored); nothing is written into cse_tpu/native/
    (whose own build products, the JAX package's library and bytecode, are
    left out of the comparison: its tests may build them meanwhile)."""
    lib = Path(audio_native.LIB_PATH)
    assert lib.parent == REPO / "cse_tpu_torch" / "_build"
    assert Path(audio_native._SOURCE) == REPO / "cse_tpu_torch" / "native" / "audio_io.cc"
    jax_dir = REPO / "cse_tpu" / "native"
    own = ("__pycache__", "libcse_audio.so")
    before = {p.name: p.stat().st_mtime_ns for p in jax_dir.iterdir() if p.name not in own}
    assert audio_native._build() and lib.exists() and not audio_native._stale()
    assert {p.name: p.stat().st_mtime_ns for p in jax_dir.iterdir() if p.name not in own} == before
    assert not list(lib.parent.glob("libcse_audio.*.so"))  # no temporary left behind


@pytest.mark.parametrize("loader", ["train", "eval"])
def test_loaders_native_path_equals_python_path(built, tmp_path, monkeypatch, loader):
    """The loaders' batch decode on the native path gives the Python reader's
    host dicts bit for bit (the corpus is PCM16, which both decode exactly;
    the train path's peak normalization is computed in fp32 by both)."""
    from cse_tpu_torch.data import datasets as ds
    from cse_tpu_torch.data import pipeline
    from cse_tpu_torch.data.synthetic import make_synthetic_corpus
    from cse_tpu_torch.data.tokenizer import ByteTokenizer

    info = make_synthetic_corpus(str(tmp_path), n_dialogs=2, turns_per_dialog=4, n_eval=4, num_test_mix=3)
    paths = ds.CorpusPaths(dailytalk=info["dailytalk_data_path"], lists_root=info["lists_root"],
                           demand=info["acoustic_noise_path"])

    def first_batch():
        if loader == "train":
            cfg = pipeline.PipelineConfig(max_sp_len=2, max_ctx_tokens=32, num_max_mix=3)
            ld = pipeline.TrainLoader(ds.build_train_list(paths, "dailytalk"), cfg, ByteTokenizer(), "dailytalk", 3,
                                      demand_files=ds.demand_noise_list(paths), seed=5, num_workers=2, device="cpu")
            out = next(iter(ld.batches(0)))
        else:
            cfg = pipeline.PipelineConfig(max_sp_len=2, max_ctx_tokens=32)
            ld = pipeline.EvalLoader(paths, "dailytalk", "test", cfg, ByteTokenizer(), 3, num_test_mix=3,
                                     num_workers=2, device="cpu")
            out = next(iter(ld.batches()))
        ld.close()
        return out

    native = first_batch()
    monkeypatch.setattr(pipeline, "native", lambda: None)
    monkeypatch.setattr(audio_io, "native", lambda: None)
    python = first_batch()
    assert set(native) == set(python)
    for k, v in python.items():
        a = native[k]
        if isinstance(v, torch.Tensor) or isinstance(v, np.ndarray):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(v), err_msg=k)
        else:
            assert a == v, k
