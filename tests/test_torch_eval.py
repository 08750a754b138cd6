"""The port's eval path against cse_tpu's on the CPU: the fp32 ``sdr`` and
``selection_accuracy`` of ops/losses.py, the copied numpy modules
(eval/metrics.py, eval/pesq.py, eval/host_metrics.py) and ``evaluate`` over
the same synthetic test set with the same tiny weights.

Tolerances: the numpy modules are the same code, so their values are equal
(atol 0). ``sdr`` in fp32: 1e-3 dB at 0, 10 and 20 dB. At 30 dB the fp32
Toeplitz solve itself (JAX's and the port's alike, held against the float64
``sdr_numpy``) errs by more than 1e-3 dB, so there both are held against
float64 at 5e-3 dB and against each other at 5e-3 dB. ``evaluate``: the same
model in fp32 on the same rows, each package with its own resampler -> the
dB metrics within 1e-3 dB, PESQ within 1e-3, ``n`` and ``acc`` equal.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import cse_tpu.eval.host_metrics as jhm
import cse_tpu.eval.metrics as jmetrics
import cse_tpu.eval.pesq as jpesq
import cse_tpu_torch.eval.host_metrics as thm
import cse_tpu_torch.eval.metrics as tmetrics
import cse_tpu_torch.eval.pesq as tpesq
from cse_tpu.data import datasets as jds
from cse_tpu.data.pipeline import EvalLoader as JaxEvalLoader
from cse_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from cse_tpu.data.tokenizer import load_tokenizer as jax_load_tokenizer
from cse_tpu.eval.evaluator import evaluate as jax_evaluate
from cse_tpu.models import Sepformer as JaxSepformer
from cse_tpu.models import SepformerConfig as JaxSepformerConfig
from cse_tpu.models.context_encoder import HashProjectionEncoder as JaxEncoder
from cse_tpu.ops.losses import sdr as jax_sdr
from cse_tpu.ops.losses import selection_accuracy as jax_selection_accuracy
from cse_tpu.train.step import TrainConfig as JaxTrainConfig
from cse_tpu.train.step import make_eval_step as jax_make_eval_step
from cse_tpu_torch.compat.jax_params import hash_encoder_tables, load_jax_params
from cse_tpu_torch.core.cli import TINY_MODEL
from cse_tpu_torch.data import datasets as tds
from cse_tpu_torch.data.pipeline import EvalLoader, PipelineConfig
from cse_tpu_torch.data.synthetic import make_synthetic_corpus
from cse_tpu_torch.data.tokenizer import load_tokenizer
from cse_tpu_torch.eval.evaluator import evaluate
from cse_tpu_torch.models import Sepformer, SepformerConfig
from cse_tpu_torch.models.context_encoder import HashProjectionEncoder
from cse_tpu_torch.ops.losses import sdr, selection_accuracy
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


DB_TOL = 1e-3
PESQ_TOL = 1e-3


def _pairs(snr_db, seed=0, B=6, T=4000):
    """Seeded (pred, target) rows: target plus white noise at ``snr_db``."""
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((B, T)).astype(np.float32)
    n = rng.standard_normal((B, T)).astype(np.float32)
    return (t + n * 10 ** (-snr_db / 20)).astype(np.float32), t


@pytest.mark.parametrize("snr_db", [0, 10, 20])
def test_sdr_matches_jax(snr_db):
    p, t = _pairs(snr_db)
    want = np.asarray(jax_sdr(jnp.asarray(p), jnp.asarray(t)))
    got = sdr(torch.from_numpy(p), torch.from_numpy(t)).numpy()
    assert got.shape == want.shape == (6,)
    np.testing.assert_allclose(got, want, rtol=0, atol=DB_TOL)
    np.testing.assert_allclose(got, tmetrics.sdr_numpy(p, t), rtol=0, atol=DB_TOL)


def test_sdr_at_30_db_within_fp32_error_of_float64():
    """At 30 dB the fp32 Toeplitz solve errs by more than the 1e-3 dB bar in
    both packages. The JAX function's own gap to float64 is read here and must
    lie past that bar (else this case belongs with the 1e-3 dB ones above);
    the port is held within 5e-3 dB of float64 and of JAX."""
    p, t = _pairs(30)
    exact = tmetrics.sdr_numpy(p, t)
    want = np.asarray(jax_sdr(jnp.asarray(p), jnp.asarray(t)))
    got = sdr(torch.from_numpy(p), torch.from_numpy(t)).numpy()
    jax_gap = float(np.abs(want - exact).max())
    assert DB_TOL < jax_gap <= 5e-3, f"jnp sdr against float64 at 30 dB: {jax_gap:.3e} dB"
    np.testing.assert_allclose(got, exact, rtol=0, atol=5e-3)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)


SDR_IN_A_PROCESS = """
import io, json, sys
import numpy as np
import torch
from cse_tpu_torch.ops.losses import sdr
if len(sys.argv) > 1:
    torch.set_num_threads(int(sys.argv[1]))
data = np.load(io.BytesIO(sys.stdin.buffer.read()))
out = sdr(torch.from_numpy(data["p"]), torch.from_numpy(data["t"]), filter_length=512)
print(json.dumps({"threads": torch.get_num_threads(), "sdr": out.tolist()}))
"""


@pytest.mark.parametrize("threads", [None, 2, 8])
def test_sdr_returns_at_any_thread_count(threads):
    """A batch's solve (B=16, T=16000, filter 512) in a fresh process at the
    default thread count (no set_num_threads) and at 2 and 8 threads: the
    batched CPU LU hung there once more than one thread was set; the port
    solves row by row on the CPU. Held against jnp ``sdr`` at the 1e-3 dB bar."""
    import io

    p, t = _pairs(10, seed=2, B=16, T=16000)
    buf = io.BytesIO()
    np.savez(buf, p=p, t=t)
    argv = [] if threads is None else [str(threads)]
    out = subprocess.run([sys.executable, "-c", SDR_IN_A_PROCESS, *argv], input=buf.getvalue(), capture_output=True,
                         timeout=120, cwd=str(Path(__file__).resolve().parents[1]))
    assert out.returncode == 0, out.stderr.decode()[-2000:]
    line = json.loads(out.stdout.decode().strip().splitlines()[-1])
    assert threads is None or line["threads"] == threads
    want = np.asarray(jax_sdr(jnp.asarray(p), jnp.asarray(t)))
    np.testing.assert_allclose(np.asarray(line["sdr"]), want, rtol=0, atol=DB_TOL)


@pytest.mark.parametrize("kw", [dict(zero_mean=True), dict(load_diag=1e-3), dict(filter_length=64)])
def test_sdr_options_match_jax(kw):
    p, t = _pairs(10, seed=1)
    want = np.asarray(jax_sdr(jnp.asarray(p), jnp.asarray(t), **kw))
    got = sdr(torch.from_numpy(p), torch.from_numpy(t), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=DB_TOL)


@pytest.mark.parametrize("n_interferers", [1, 2])
def test_selection_accuracy_matches_jax(n_interferers):
    rng = np.random.default_rng(n_interferers)
    B, T = 16, 800
    gt = rng.standard_normal((B, T)).astype(np.float32)
    inter = rng.standard_normal((B, T, n_interferers)).astype(np.float32)
    # each row closer to gt or to one of its interferers
    w = rng.uniform(0.0, 1.0, (B, 1)).astype(np.float32)
    pred = (w * gt + (1 - w) * inter[..., 0] + 0.1 * rng.standard_normal((B, T))).astype(np.float32)
    want = np.asarray(jax_selection_accuracy(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(inter)))
    got = selection_accuracy(torch.from_numpy(pred), torch.from_numpy(gt), torch.from_numpy(inter)).numpy()
    assert got.dtype == np.int32 and 0 < got.sum() < B
    np.testing.assert_array_equal(got, want)


def _speech_like(seed, n=8000, sr=8000):
    """A voiced-ish 1 s signal (harmonics under a syllable envelope) and a
    noisy, delayed copy."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    f0 = 110 + 40 * rng.random()
    x = sum(np.sin(2 * np.pi * f0 * k * t + rng.random()) / k for k in range(1, 12))
    x *= 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t) ** 2
    y = np.roll(x, 17) + 0.1 * rng.standard_normal(n)
    return x, y


def test_numpy_metrics_are_the_same_code():
    x, y = _speech_like(0)
    assert tpesq.pesq_nb(x, y) == jpesq.pesq_nb(x, y)
    assert tpesq.mos_lqo(2.5) == jpesq.mos_lqo(2.5)
    p, t = _pairs(12, seed=3, B=3, T=3000)
    np.testing.assert_array_equal(tmetrics.si_snr_numpy(p, t), jmetrics.si_snr_numpy(p, t))
    np.testing.assert_array_equal(tmetrics.sdr_numpy(p, t), jmetrics.sdr_numpy(p, t))
    a, b = tmetrics.SiSnrMetric(), jmetrics.SiSnrMetric()
    for m in (a, b):
        m.update(p, t)
    assert a.compute() == b.compute()
    assert np.isnan(tmetrics.SdrMetric().compute())


@pytest.mark.parametrize("workers", [0, 2])
def test_host_metrics_pool_matches_jax(workers):
    rows = [_speech_like(s) for s in range(5)]
    gt = np.stack([r[0] for r in rows])
    enh = np.stack([r[1] for r in rows])
    lens = np.array([8000, 7000, 6000, 8000, 4000])
    got = {}
    for name, mod in (("port", thm), ("jax", jhm)):
        with mod.HostMetricsPool(sr=8000, workers=workers) as pool:
            if workers:
                assert pool._pool is not None  # a real 2-process pool, not the in-process path
            pool.submit_pesq("pesq", enh, gt, lengths=lens)
            pool.submit_sdr("sdr", enh, gt)
            got[name] = (pool.sums("pesq"), pool.sums("sdr"), pool.mean("pesq"), pool.mean("none"))
    assert got["port"][:3] == got["jax"][:3]
    assert got["port"][0][1] == 5 and np.isnan(got["port"][3])


def test_metric_workers_load_no_torch():
    """A spawned worker imports the worker functions' module (and the
    package): neither may load torch."""
    code = ("import sys, cse_tpu_torch.eval.host_metrics as h, cse_tpu_torch.eval.pesq, "
            "cse_tpu_torch.eval.metrics; print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=str(Path(__file__).resolve().parents[1]))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    return make_synthetic_corpus(str(root), num_test_mix=2, corpus="dailytalk")


def _loaders(info, B=2):
    """The port's and cse_tpu's EvalLoader over the same rows."""
    kw = dict(max_sp_len=2, sr=8000, num_max_mix=2, context_length=0, max_ctx_tokens=16)
    paths = dict(dailytalk=info["dailytalk_data_path"], demand=info["acoustic_noise_path"],
                 lists_root=info["lists_root"])
    port = EvalLoader(tds.CorpusPaths(**paths), "dailytalk", "test", PipelineConfig(**kw),
                      load_tokenizer("__none__"), B, num_workers=2, device="cpu")
    jax_ = JaxEvalLoader(jds.CorpusPaths(**paths), "dailytalk", "test", JaxPipelineConfig(**kw),
                         jax_load_tokenizer("__none__"), B, num_workers=2)
    return port, jax_


@pytest.mark.parametrize("limit", [None, 2])
def test_prev_cache_key_matches_jax(corpus, limit):
    port, jax_ = _loaders(corpus)
    try:
        key = thm.prev_cache_key(port, 8000, limit)
        assert key == jhm.prev_cache_key(jax_, 8000, limit)
        assert len(key) == 32 and key != thm.prev_cache_key(port, 16000, limit)
    finally:
        port.close()


def _results_lines(path):
    out = {}
    for line in path.read_text().splitlines():
        name, value = line.rsplit(": ", 1)
        out[name] = float(value)
    return out


@pytest.mark.parametrize("variant", ["context", "contsep"])
def test_evaluate_matches_jax(corpus, tmp_path, variant):
    jmodel = JaxSepformer(JaxSepformerConfig(variant=variant, **TINY_MODEL))
    params = jmodel.init(jax.random.key(0), jnp.zeros((2, 4000)), jnp.zeros((2, 1, 4096)))
    jfn, jps = JaxEncoder(dim=4096, ctx_length=1).pure()
    use_ce = variant == "context"  # contsep: the 2-speaker BCE head's sign, as on DailyTalk
    jstep = jax_make_eval_step(jmodel, JaxTrainConfig(variant=variant, use_ce=use_ce), llm_apply=jfn,
                               llm_params=jps)

    model = load_jax_params(Sepformer(SepformerConfig(variant=variant, **TINY_MODEL)),
                            jax.tree.map(np.asarray, params))
    key = jax.random.key(0)
    tables = hash_encoder_tables(np.asarray(jax.random.normal(key, (1, 1, 4096)) * 0.02),
                                 np.asarray(jax.random.uniform(jax.random.fold_in(key, 1), (1, 1, 4096)) * 6.283))
    tfn, tps = HashProjectionEncoder(dim=4096, ctx_length=1, tables=tables).pure()
    step = make_eval_step(model, TrainConfig(variant=variant, use_ce=use_ce), device="cpu", llm_apply=tfn,
                          llm_params=tps)

    port_loader, jax_loader = _loaders(corpus)
    kw = dict(sr=8000, dir_name="d", test_dataset="dailytalk", metric_workers=0, verbose=False)
    try:
        got = evaluate(step, port_loader, save_dir=str(tmp_path / "port"), **kw)
    finally:
        port_loader.close()
    want = jax_evaluate(jstep, params, jax_loader, save_dir=str(tmp_path / "jax"), **kw)

    assert got["n"] == want["n"] == 6 and got["acc"] == want["acc"]
    assert set(got) == set(want)
    for k in ("si_snr", "sdr", "si_snr_i", "sdr_i"):
        assert np.isfinite(got[k]) and abs(got[k] - want[k]) <= DB_TOL, (k, got[k], want[k])
    for k in ("pesq", "pesq_i"):
        assert np.isfinite(got[k]) and abs(got[k] - want[k]) <= PESQ_TOL, (k, got[k], want[k])
    res = [_results_lines(tmp_path / side / "d" / "test_results_dailytalk.txt") for side in ("port", "jax")]
    assert list(res[0]) == list(res[1]) == ["Test SI-SNR", "Test SDR", "Test SI-SNR-I", "Test SDR-I",
                                            "Test PESQ-p862", "Test PESQ-p862-I"]
    for name in res[0]:
        tol = PESQ_TOL if "PESQ" in name else DB_TOL
        assert abs(res[0][name] - res[1][name]) <= tol, name
    accs = [(tmp_path / side / "d" / "acc_dailytalk.txt").read_text() for side in ("port", "jax")]
    assert accs[0] == accs[1]
