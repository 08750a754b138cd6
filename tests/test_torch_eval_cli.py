"""The port's eval entry points, ``python -m cse_tpu_torch.test`` and
``python -m cse_tpu_torch.test_HContExt``, end to end on the CPU over the
synthetic corpus (tests/test_eval_cli.py's flags, with the trainer's tiny
model): result files written, ``n`` >= 1, finite metrics; a released-form
checkpoint; no CPU fallback without ``--platform``; and ``evaluate``'s
``prepare_batch`` (the H-ContExt enrollment) and ``limit_batches`` against
cse_tpu's evaluator with the same tiny weights and stand-ins (the dB metrics
within 1e-3 dB, PESQ within 1e-3, as tests/test_torch_eval.py)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from cse_tpu.data import datasets as jds
from cse_tpu.data.pipeline import EvalLoader as JaxEvalLoader
from cse_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from cse_tpu.data.tokenizer import load_tokenizer as jax_load_tokenizer
from cse_tpu.eval.enrollment import eval_enrollment_embeddings as jax_eval_enrollment
from cse_tpu.eval.evaluator import evaluate as jax_evaluate
from cse_tpu.models import Sepformer as JaxSepformer
from cse_tpu.models import SepformerConfig as JaxSepformerConfig
from cse_tpu.models import speaker_encoder as jspeaker
from cse_tpu.models.context_encoder import HashProjectionEncoder as JaxEncoder
from cse_tpu.train.step import TrainConfig as JaxTrainConfig
from cse_tpu.train.step import make_eval_step as jax_make_eval_step
from cse_tpu_torch import test as eval_cli
from cse_tpu_torch import test_HContExt as hcontext_cli
from cse_tpu_torch.compat.jax_params import hash_encoder_tables, load_jax_params, spectral_projection_from_jax
from cse_tpu_torch.compat.torch_export import save_torch_checkpoint
from cse_tpu_torch.core.cli import TINY_MODEL
from cse_tpu_torch.core.flags import parse_test_args
from cse_tpu_torch.data import datasets as tds
from cse_tpu_torch.data.pipeline import EvalLoader, PipelineConfig
from cse_tpu_torch.data.synthetic import make_synthetic_corpus
from cse_tpu_torch.data.tokenizer import load_tokenizer
from cse_tpu_torch.eval.enrollment import eval_enrollment_embeddings
from cse_tpu_torch.eval.evaluator import evaluate
from cse_tpu_torch.models import Sepformer, SepformerConfig
from cse_tpu_torch.models.context_encoder import HashProjectionEncoder
from cse_tpu_torch.models.speaker_encoder import SpectralSpeakerEncoder
from cse_tpu_torch.train.step import TrainConfig, make_eval_step

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def one_blas_thread(monkeypatch):
    """PESQ's many small BLAS calls thrash OpenBLAS's thread pool when the
    suite's workers share the cores. The spawned metric workers inherit the
    environment."""
    monkeypatch.setenv("OPENBLAS_NUM_THREADS", "1")
    with threadpool_limits(limits=1, user_api="blas"):
        yield


COMMON = ["--synthetic_smoke", "--platform", "cpu", "--mode", "test", "--train_data", "dailytalk",
          "--max_sp_len", "2", "--max_ctx_tokens", "16", "--workers", "2", "--debug_tiny_model",
          "--batch_size", "2"]


DB_TOL = 1e-3
PESQ_TOL = 1e-3


def _check(res, out, n_min=1):
    """Real rows were scored, the metrics are finite and both files are there."""
    assert res["n"] >= n_min, res
    assert all(math.isfinite(res[k]) for k in ("si_snr", "sdr", "si_snr_i", "sdr_i", "pesq")), res
    lines = (out / "test_results_dailytalk.txt").read_text().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["Test SI-SNR", "Test SDR", "Test SI-SNR-I", "Test SDR-I",
                                                  "Test PESQ-p862", "Test PESQ-p862-I"]
    assert float(lines[0].split(": ")[1]) == res["si_snr"]
    assert (out / "acc_dailytalk.txt").read_text() == f"{res['acc']:.4f}\n"


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("test_model,workers", [("ContExt", "2"), ("ContSep", "0")])
def test_eval_cli_synthetic(tmp_path, test_model, workers, fused):
    argv = COMMON + ["--test_model", test_model, "--save_dir", str(tmp_path), "--metric_workers", workers]
    res = eval_cli.main(argv + (["--fused_eval"] if fused else []))
    _check(res, tmp_path / "random_init" / "2_speaker_0_ctx")
    assert res["n"] == 6


@pytest.mark.parametrize("fused", [False, True])
def test_eval_cli_contsep_3spk(tmp_path, fused):
    """Three speakers (tests/test_eval_cli.py::test_eval_cli_contsep_3spk's
    flags): the mixed_3speaker / gt_3speaker / noise_{1,2}_3speaker corpus,
    the CE selector over three streams, results under 3_speaker_0_ctx; the
    fused eval scores what the plain one does."""
    argv = COMMON + ["--test_model", "ContSep", "--num_max_mix", "3", "--num_test_mix", "3",
                     "--save_dir", str(tmp_path), "--metric_workers", "0"]
    res = eval_cli.main(argv + (["--fused_eval"] if fused else []))
    _check(res, tmp_path / "random_init" / "3_speaker_0_ctx")
    assert res["n"] == 6


def test_eval_cli_released_checkpoint(tmp_path):
    model = Sepformer(SepformerConfig(variant="context", **TINY_MODEL), generator=torch.Generator().manual_seed(5))
    ckpt = tmp_path / "ckpts" / "released.ckpt"
    ckpt.parent.mkdir()
    save_torch_checkpoint(str(ckpt), model, step=11, epoch=2)
    argv = COMMON + ["--test_model", "ContExt", "--save_dir", str(tmp_path / "out"), "--checkpoint", str(ckpt),
                     "--metric_workers", "0"]
    loaded, cfg = eval_cli.build_test_model(parse_test_args(argv), "cpu")
    assert cfg.variant == "context" and cfg.d_model == TINY_MODEL["d_model"]
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in model.state_dict().items())
    res = eval_cli.main(argv)
    _check(res, tmp_path / "out" / "ckpts" / "released" / "2_speaker_0_ctx")


def test_eval_cli_synthetic_eval_sets_the_test_set_size(tmp_path):
    argv = COMMON + ["--test_model", "ContExt", "--save_dir", str(tmp_path), "--metric_workers", "0",
                     "--synthetic_eval", "3"]
    res = eval_cli.main(argv)
    _check(res, tmp_path / "random_init" / "2_speaker_0_ctx")
    assert res["n"] == 3


def test_eval_cli_needs_a_card_without_platform(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in COMMON if a not in ("--platform", "cpu")] + ["--save_dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_cli.main(argv)
    assert not list(tmp_path.rglob("*.txt"))


@pytest.mark.parametrize("cue,extra", [("joint", []), ("history", []), ("voice", []), ("joint", ["--one_sec"])])
def test_hcontext_cli_synthetic(tmp_path, cue, extra, capsys):
    argv = COMMON + ["--cue", cue, "--save_dir", str(tmp_path), "--metric_workers", "0"] + extra
    res = hcontext_cli.main(argv)
    _check(res, tmp_path / "random_init" / f"2_speaker_0_ctx_{cue}")
    assert res["n"] == 6
    assert "ecapa=STUB" in capsys.readouterr().out  # no --ecapa_path: the banner names the stand-in


def test_hcontext_cli_needs_a_card_without_platform(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in COMMON if a not in ("--platform", "cpu")] + ["--save_dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA"):
        hcontext_cli.main(argv)
    assert not list(tmp_path.rglob("*.txt"))


def test_evaluate_prepare_batch_and_limit_batches_match_jax(tmp_path):
    """The tiny H-ContExt model carried from cse_tpu, each package's
    enrollment attached by ``prepare_batch`` (its stand-in, on the same
    projection), the first 2 of 3 batches scored."""
    info = make_synthetic_corpus(str(tmp_path / "corpus"), num_test_mix=2, corpus="dailytalk")
    kw = dict(max_sp_len=2, sr=8000, num_max_mix=2, context_length=0, max_ctx_tokens=16)
    paths = dict(dailytalk=info["dailytalk_data_path"])
    jmodel = JaxSepformer(JaxSepformerConfig(variant="context", add_se=True, **TINY_MODEL))
    params = jmodel.init(jax.random.key(0), jnp.zeros((2, 4000)), jnp.zeros((2, 1, 4096)),
                         se=jnp.zeros((2, 1, 192)), cue_index=jnp.asarray(0))
    jfn, jps = JaxEncoder(dim=4096, ctx_length=1).pure()
    jstep = jax_make_eval_step(jmodel, JaxTrainConfig(variant="hcontext"), llm_apply=jfn, llm_params=jps)
    jspeaker.configure_speaker_encoder(None)  # cse_tpu's process-wide encoder: its stand-in

    def jax_prepare(batch):
        batch["se"] = jax_eval_enrollment(batch, "dailytalk", "test", jds.CorpusPaths(**paths))
        return batch

    model = load_jax_params(Sepformer(SepformerConfig(variant="context", add_se=True, **TINY_MODEL)),
                            jax.tree.map(np.asarray, params))
    key = jax.random.key(0)
    tables = hash_encoder_tables(np.asarray(jax.random.normal(key, (1, 1, 4096)) * 0.02),
                                 np.asarray(jax.random.uniform(jax.random.fold_in(key, 1), (1, 1, 4096)) * 6.283))
    tfn, tps = HashProjectionEncoder(dim=4096, ctx_length=1, tables=tables).pure()
    step = make_eval_step(model, TrainConfig(variant="hcontext"), device="cpu", llm_apply=tfn, llm_params=tps)
    stand = SpectralSpeakerEncoder(projection=spectral_projection_from_jax(
        np.asarray(jax.random.normal(jax.random.key(0), (402, 192)))))
    prepared = []

    def prepare(batch):
        batch["se"] = eval_enrollment_embeddings(batch, "dailytalk", "test", tds.CorpusPaths(**paths), stand)
        prepared.append(batch["se"].shape)
        return batch

    ekw = dict(sr=8000, dir_name="d", test_dataset="dailytalk", metric_workers=0, verbose=False, limit_batches=2)
    port_loader = EvalLoader(tds.CorpusPaths(**paths), "dailytalk", "test", PipelineConfig(**kw),
                             load_tokenizer("__none__"), 2, num_workers=2, device="cpu")
    try:
        got = evaluate(step, port_loader, save_dir=str(tmp_path / "port"), prepare_batch=prepare, **ekw)
    finally:
        port_loader.close()
    jax_loader = JaxEvalLoader(jds.CorpusPaths(**paths), "dailytalk", "test", JaxPipelineConfig(**kw),
                               jax_load_tokenizer("__none__"), 2, num_workers=2)
    want = jax_evaluate(jstep, params, jax_loader, save_dir=str(tmp_path / "jax"), prepare_batch=jax_prepare, **ekw)

    assert got["n"] == want["n"] == 4 and prepared == [(2, 1, 192)] * 2 and got["acc"] == want["acc"]
    for k in ("si_snr", "sdr", "si_snr_i", "sdr_i"):
        assert np.isfinite(got[k]) and abs(got[k] - want[k]) <= DB_TOL, (k, got[k], want[k])
    for k in ("pesq", "pesq_i"):
        assert np.isfinite(got[k]) and abs(got[k] - want[k]) <= PESQ_TOL, (k, got[k], want[k])
