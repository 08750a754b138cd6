"""cse_tpu_torch.data against cse_tpu.data: the synthetic corpus byte for
byte, the loaders' host dicts bit for bit, the device synthesis and the eval
resampling at atol 2e-5 (the same fp32 arithmetic through a dozen stages in
another summation order), the int16 wire, and prefetch's error and abort rules."""

import filecmp
import itertools
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cse_tpu.data import datasets as jds
from cse_tpu.data import pipeline as jpipe
from cse_tpu.data.synthetic import make_synthetic_corpus as jax_make_corpus
from cse_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from cse_tpu_torch.data import datasets as tds
from cse_tpu_torch.data import pipeline as tpipe
from cse_tpu_torch.data.audio_io import read_wav, write_wav
from cse_tpu_torch.data.synthetic import make_synthetic_corpus
from cse_tpu_torch.data.tokenizer import ByteTokenizer, encode_batch

torch.set_num_threads(1)
ATOL = 2e-5


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The same corpus (one seed) made by each package, in its own directory."""
    kw = dict(n_dialogs=3, turns_per_dialog=5, n_eval=5, num_test_mix=3)
    jroot, troot = (str(tmp_path_factory.mktemp(n)) for n in ("jax_corpus", "torch_corpus"))
    return jroot, jax_make_corpus(jroot, **kw), troot, make_synthetic_corpus(troot, **kw)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def test_synthetic_corpus_is_byte_identical(corpora):
    jroot, jinfo, troot, tinfo = corpora
    files = _files(jroot)
    assert files == _files(troot) and len(files) > 30
    _, mismatch, errors = filecmp.cmpfiles(jroot, troot, files, shallow=False)
    assert not mismatch and not errors
    assert {k: os.path.relpath(v, jroot) for k, v in jinfo.items()} == \
        {k: os.path.relpath(v, troot) for k, v in tinfo.items()}


def _loaders(corpora, cfg_kw, seed=5, B=3):
    """Both packages' TrainLoaders over the port's copy of the corpus."""
    _, _, _, info = corpora
    out = []
    for ds_, pipe, tok in ((jds, jpipe, JaxByteTokenizer()), (tds, tpipe, ByteTokenizer())):
        paths = ds_.CorpusPaths(dailytalk=info["dailytalk_data_path"], lists_root=info["lists_root"])
        files = ds_.build_train_list(paths, "dailytalk")
        demand = ds_.demand_noise_list(ds_.CorpusPaths(demand=info["acoustic_noise_path"]))
        cfg = pipe.PipelineConfig(max_sp_len=2, max_ctx_tokens=48, **cfg_kw)
        kw = dict(demand_files=demand if cfg.noise_add else None, seed=seed, num_workers=2,
                  process_index=0, process_count=1)
        if pipe is tpipe:
            kw["device"] = "cpu"
        out.append((pipe.TrainLoader(files, cfg, tok, "dailytalk", B, **kw), cfg))
    return out


CASES = {"2spk_noise": dict(num_max_mix=2, noise_add=True),
         "2spk_clean": dict(num_max_mix=2, noise_add=False),
         "3spk_noise": dict(num_max_mix=3, noise_add=True, shift_prob=0.9),
         "3spk_noaug": dict(num_max_mix=3, noise_add=False, augmentation=False),
         "2spk_aligned": dict(num_max_mix=2, noise_add=True, aligned_buckets=True)}


@pytest.mark.parametrize("case", list(CASES))
def test_train_loader_host_dicts_bit_identical_and_synthesis_matches(corpora, case):
    (jl, jcfg), (tl, tcfg) = _loaders(corpora, CASES[case])
    assert jcfg.t16 == tcfg.t16 and jcfg.t_model == tcfg.t_model
    assert jl.epoch_indices(0) == tl.epoch_indices(0)
    jb, tb = list(jl.batches(0)), list(tl.batches(0))
    assert len(jb) == len(tb) == 5  # 15 utterances, B=3: one epoch
    for jh, th in zip(jb, tb):
        assert sorted(jh) == sorted(th)
        for k in jh:
            assert jh[k].dtype == th[k].dtype, k
            np.testing.assert_array_equal(jh[k], th[k], err_msg=k)
        assert th["source"].dtype == np.int16
    for jh, th in zip(jb[:2], tb[:2]):
        want, got = jl.device_batch(jh), tl.device_batch(th)
        assert sorted(want) == sorted(got)
        assert tl.h2d_bytes == sum(v.nbytes for v in th.values())
        for k in want:
            w = np.asarray(want[k])
            assert tuple(got[k].shape) == w.shape, k
            if w.dtype.kind in "iub":
                np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
            else:
                np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=ATOL, err_msg=k)
        assert got["mixed"].shape == (3, tcfg.t_model) and got["noises"].shape[-1] == tcfg.num_max_mix - 1
    jl.close()
    tl.close()


def test_host_sharding_disjoint(corpora):
    (_, _), (tl, tcfg) = _loaders(corpora, CASES["2spk_clean"])
    shards = []
    for pi in range(2):
        loader = tpipe.TrainLoader(tl.files, tcfg, ByteTokenizer(), "dailytalk", 2, seed=3,
                                   process_index=pi, process_count=2, device="cpu")
        shards.append(set(loader.epoch_indices(0)))
        loader.close()
    assert shards[0].isdisjoint(shards[1]) and len(shards[0] | shards[1]) == len(tl.files)


@pytest.mark.parametrize("num_test_mix,sr", [(3, 8000), (3, 16000)])
def test_eval_loader_matches(corpora, num_test_mix, sr):
    _, _, _, info = corpora
    batches = []
    for ds_, pipe, tok in ((jds, jpipe, JaxByteTokenizer()), (tds, tpipe, ByteTokenizer())):
        paths = ds_.CorpusPaths(dailytalk=info["dailytalk_data_path"])
        cfg = pipe.PipelineConfig(max_sp_len=4, max_ctx_tokens=64, sr=sr)
        kw = dict(device="cpu") if pipe is tpipe else {}
        loader = pipe.EvalLoader(paths, "dailytalk", "test", cfg, tok, batch_size=2, num_test_mix=num_test_mix,
                                 num_workers=2, **kw)
        assert len(loader) == 5
        batches.append(list(loader.batches()))
        assert len(list(loader.batches(limit_batches=1))) == 1
        loader.close()
    assert len(batches[0]) == len(batches[1]) == 3
    for want, got in zip(*batches):
        assert sorted(want) == sorted(got)
        for k in ("names", "contexts", "paths"):
            assert want[k] == got[k]
        for k in ("gt16k", "gt16k_len"):
            np.testing.assert_array_equal(want[k], got[k])
        for k in ("context_ids", "context_mask", "sp_len"):
            np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy(), err_msg=k)
        for k in ("mixed", "gt", "noises"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=ATOL, err_msg=k)
        assert got["noises"].shape[-1] == num_test_mix - 1 and got["mixed"].shape[1] == 4 * sr
    with pytest.raises(ValueError, match="num_test_mix"):
        tpipe.EvalLoader(tds.CorpusPaths(dailytalk=info["dailytalk_data_path"]), "dailytalk", "test",
                         tpipe.PipelineConfig(), ByteTokenizer(), 2, num_test_mix=4, device="cpu")


def test_resample_eval_batch_matches(rng):
    host = {"mixed": jpipe.wire_int16(rng.uniform(-1, 1, (2, 3200)).astype(np.float32)),
            "gt": jpipe.wire_int16(rng.uniform(-1, 1, (2, 3200)).astype(np.float32)),
            "noises": jpipe.wire_int16(rng.uniform(-1, 1, (2, 3200, 2)).astype(np.float32)),
            "sp_len": np.array([3200, 1601], np.int32)}
    want = jpipe.resample_eval_batch(8000, {k: jnp.asarray(v) for k, v in host.items()})
    got = tpipe.resample_eval_batch(8000, host)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=ATOL, err_msg=k)
    assert got["sp_len"].tolist() == [1600, 801] and got["sp_len"].dtype == torch.int32
    same = tpipe.resample_eval_batch(16000, host)
    assert same["mixed"].dtype == torch.float32 and same["mixed"].shape == (2, 3200)


def test_int16_wire_roundtrip(tmp_path, rng):
    x = rng.uniform(-1.0, 1.0, 8000).astype(np.float32)
    np.testing.assert_array_equal(tpipe.wire_int16(x), jpipe.wire_int16(x))
    back = tpipe._unwire(torch.from_numpy(tpipe.wire_int16(x))).numpy()
    assert np.abs(back - x).max() <= (1.0 / 32768.0) + 1e-7
    p = str(tmp_path / "w.wav")
    write_wav(p, x, 16000)
    d, sr = read_wav(p)
    assert sr == 16000
    np.testing.assert_array_equal(tpipe._unwire(torch.from_numpy(tpipe.wire_int16(d))).numpy(), d)
    f = torch.from_numpy(x)
    assert tpipe._unwire(f) is f


def test_tokenizer_and_context_match(corpora):
    _, _, _, info = corpora
    files = tds.build_train_list(tds.CorpusPaths(dailytalk=info["dailytalk_data_path"],
                                                 lists_root=info["lists_root"]), "dailytalk")
    ctxs = [tds.assemble_context(f, "dailytalk", "test", context_length=0) for f in files[:5]]
    assert ctxs == [jds.assemble_context(f, "dailytalk", "test", context_length=0) for f in files[:5]]
    from cse_tpu.data.tokenizer import encode_batch as jax_encode_batch

    for kw in (dict(), dict(buckets=(32, 128))):
        for a, b in zip(encode_batch(ByteTokenizer(), ctxs, 96, **kw),
                        jax_encode_batch(JaxByteTokenizer(), ctxs, 96, **kw)):
            np.testing.assert_array_equal(a, b)


def test_prefetch_propagates_worker_errors():
    def bad_iter():
        yield 1
        raise RuntimeError("decode failed")

    it = tpipe.prefetch(bad_iter())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="decode failed"):
        list(it)


def test_prefetch_consumer_abort_releases_worker():
    produced = []

    def gen():
        for i in itertools.count():
            produced.append(i)
            yield i

    it = tpipe.prefetch(gen(), depth=2)
    assert next(it) == 0
    it.close()  # consumer aborts (same path as an exception in its loop)
    time.sleep(0.4)  # > the worker's 100 ms stop-poll
    n = len(produced)
    time.sleep(0.3)
    assert len(produced) == n, "producer kept running after consumer abort"


def test_prefetch_yields_everything_in_order():
    assert list(tpipe.prefetch(iter(range(7)), depth=2)) == list(range(7))
