"""The port's eval entry point, ``python -m cse_tpu_torch.test``, end to end
on the CPU over the synthetic corpus (tests/test_eval_cli.py's flags, with
the trainer's tiny model): result files written, ``n`` >= 1, finite
metrics; a released-form checkpoint; and no CPU fallback without
``--platform``."""

import math

import pytest
import torch
from threadpoolctl import threadpool_limits

from cse_tpu_torch import test as eval_cli
from cse_tpu_torch.compat.torch_export import save_torch_checkpoint
from cse_tpu_torch.core.cli import TINY_MODEL
from cse_tpu_torch.core.flags import parse_test_args
from cse_tpu_torch.models import Sepformer, SepformerConfig

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
