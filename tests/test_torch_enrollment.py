"""H-ContExt's enrollment cues on the CPU against cse_tpu's: the train-time
crop (``data/pipeline.py::crop_enrollment``, fed JAX's own draws: the same
bits, with rows under 1 s and of length 0) and the eval-time embeddings
(``eval/enrollment.py``) on the synthetic corpus for each rule (DailyTalk's
register wavs, TEDLIUM's first gt of the speaker, the 1 s crop of the gt),
with the same buffers, lengths and stand-in (1e-5)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cse_tpu.data import datasets as jds
from cse_tpu.data.pipeline import crop_enrollment as jax_crop_enrollment
from cse_tpu.eval.enrollment import eval_enrollment_embeddings as jax_eval_enrollment
from cse_tpu.models import speaker_encoder as jspeaker
from cse_tpu_torch.compat.jax_params import spectral_projection_from_jax
from cse_tpu_torch.data import datasets as tds
from cse_tpu_torch.data.audio_io import write_wav
from cse_tpu_torch.data.pipeline import EvalLoader, PipelineConfig, crop_enrollment, draw_enrollment
from cse_tpu_torch.data.synthetic import make_synthetic_corpus
from cse_tpu_torch.data.tokenizer import ByteTokenizer
from cse_tpu_torch.eval.enrollment import eval_enrollment_embeddings
from cse_tpu_torch.models.speaker_encoder import SpectralSpeakerEncoder

torch.set_num_threads(1)


@pytest.mark.parametrize("T,seed", [(40000, 0), (100000, 1)])
def test_crop_matches_jax_on_its_draws(T, seed):
    """A buffer shorter and one longer than the 5 s crop; rows of the whole
    buffer, 2.5 s, 0.5 s, 1 sample and 0 samples."""
    rng = np.random.default_rng(seed)
    gt = rng.standard_normal((6, T)).astype(np.float32)
    lengths = np.array([T, 40000, 8000, 1, 0, T // 3], np.int32)
    key = jax.random.key(seed)
    want, want_len = jax_crop_enrollment(jnp.asarray(gt), jnp.asarray(lengths), key)
    k1, k2 = jax.random.split(key)  # the draws crop_enrollment makes from its key
    seconds = np.array(jax.random.randint(k1, (6,), 1, 6))
    u = np.array(jax.random.uniform(k2, (6,)))
    got, got_len = crop_enrollment(torch.from_numpy(gt), torch.from_numpy(lengths), torch.from_numpy(seconds),
                                   torch.from_numpy(u))
    assert got.shape == (6, 80000)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got_len[4] == 1 and (got[4, 1:] == 0).all()  # a zero-length row keeps one sample


def test_draw_enrollment_ranges_and_repeats():
    seconds, u = draw_enrollment(4096, torch.Generator().manual_seed(5))
    assert seconds.dtype == torch.int64 and set(seconds.tolist()) == {1, 2, 3, 4, 5}
    assert 0 <= float(u.min()) and float(u.max()) < 1
    again = draw_enrollment(4096, torch.Generator().manual_seed(5))
    assert torch.equal(seconds, again[0]) and torch.equal(u, again[1])


@pytest.fixture(scope="module")
def stand_ins():
    """Each package's spectral stand-in on the same projection."""
    jspeaker.configure_speaker_encoder(None)
    W = np.asarray(jax.random.normal(jax.random.key(0), (402, 192)))
    return SpectralSpeakerEncoder(projection=spectral_projection_from_jax(W))


RULES = {"dailytalk": ("dailytalk", False, True), "dailytalk-no-register": ("dailytalk", False, False),
         "tedlium": ("tedlium", False, False), "one_sec": ("dailytalk", True, True)}


@pytest.mark.parametrize("rule", list(RULES))
def test_eval_enrollment_matches_jax(tmp_path, stand_ins, rule):
    corpus, one_sec, register = RULES[rule]
    info = make_synthetic_corpus(str(tmp_path), corpus=corpus, n_dialogs=2, turns_per_dialog=2, n_eval=3,
                                 seconds=(1.5, 3.0))
    root = info[f"{corpus}_data_path"]
    if register:  # speaker 0's fixed register wav: 2.2 s, longer than the crops
        write_wav(os.path.join(root, "test/gt/237_0_0_d237-72_4_1_d72-3.9282.wav"),
                  0.3 * np.random.default_rng(2).standard_normal(35200).astype(np.float32), 16000)
    loader = EvalLoader(tds.CorpusPaths(**{corpus: root}), corpus, "val", PipelineConfig(max_sp_len=4),
                        ByteTokenizer(), batch_size=3, num_workers=2, device="cpu")
    batch = next(iter(loader.batches()))
    loader.close()
    kw = dict(num_test_mix=2, seed=7, one_sec=one_sec)
    want = np.asarray(jax_eval_enrollment(batch, corpus, "val", jds.CorpusPaths(**{corpus: root}), **kw))
    got = eval_enrollment_embeddings(batch, corpus, "val", tds.CorpusPaths(**{corpus: root}), stand_ins, **kw)
    assert got.shape == want.shape == (3, 1, 192)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if rule == "one_sec":  # the crops differ per item, and from the register's embedding
        registered = eval_enrollment_embeddings(batch, corpus, "val", tds.CorpusPaths(**{corpus: root}), stand_ins,
                                                num_test_mix=2, seed=7)
        assert not torch.allclose(got[0], got[1]) and not torch.allclose(got[0], registered[0])
