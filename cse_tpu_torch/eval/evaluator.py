"""Test-set evaluation mirroring the reference ``test.py`` protocol.

Port of ``cse_tpu/eval/evaluator.py``. Computes SI-SNR / SDR (+ improvements
over the mixture) with float64 host accumulators, stream-selection accuracy
(pred closer to gt than to every interferer, reference ``test.py:248-255``),
optional peak-normed PCM_16 wav dumps, and writes ``test_results_{ds}.txt`` /
``acc_{ds}.txt`` (reference ``test.py:303-310``).

Host metrics do not serialize with the device: PESQ (per utterance) and the
Toeplitz-solve SDR (per batch) are submitted to a worker-process pool as
device results stream out and gathered once at the end
(:mod:`cse_tpu_torch.eval.host_metrics`), and the mixture-side ("prev")
accumulations — functions of the test set only, not of the model — are
cached across evaluations keyed by the loader's exact row set.

The eval step is the port's (:func:`cse_tpu_torch.train.step.make_eval_step`):
``eval_step(batch) -> (enhanced, aux)`` with the model bound, where the JAX
package's takes ``(params, batch)``. ``prepare_batch(batch) -> batch`` runs on
each batch in the consumer thread, after the prefetch (H-ContExt attaches
its enrollment embeddings there); ``limit_batches`` scores the first batches
only.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cse_tpu_torch.data.audio_io import write_wav
from cse_tpu_torch.data.pipeline import EvalLoader, prefetch
from cse_tpu_torch.eval.host_metrics import (
    HostMetricsPool,
    load_prev_cache,
    prev_cache_key,
    store_prev_cache,
)
from cse_tpu_torch.eval.metrics import SiSnrMetric, si_snr_numpy

MODEL_KEYS = ("mixed", "gt", "noises", "context_ids", "context_mask", "se", "ctx_feat")


def _host(t) -> np.ndarray:
    """A batch array (a device tensor or a host array) as numpy: one copy to the host."""
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def evaluate(
    eval_step,
    loader: EvalLoader,
    sr: int,
    save_dir: str | None = None,
    dir_name: str = "",
    test_dataset: str = "",
    generate_speech: bool = False,
    prepare_batch=None,
    limit_batches: int | None = None,
    verbose: bool = True,
    metric_workers: int | None = None,
    prev_cache_dir: str | None = None,
) -> dict:
    m_sisnr, m_sisnr_prev = SiSnrMetric(), SiSnrMetric()
    accs: list[np.ndarray] = []

    # mixture-side metrics depend only on the test set: reuse a cached
    # accumulation when the loader's exact row set was measured before
    cache_key = prev_cache_key(loader, sr, limit_batches)
    prev_cached = load_prev_cache(prev_cache_dir, cache_key)
    need_prev = prev_cached is None

    pool = HostMetricsPool(sr=sr, workers=metric_workers)
    total = len(loader)
    seen = 0
    # host decode of batch N+1 overlaps the device step + float64 host
    # metrics of batch N; prepare_batch stays in the consumer thread
    batches = prefetch(loader.batches(limit_batches=limit_batches), depth=2)
    try:
        for bi, batch in enumerate(batches):
            if prepare_batch is not None:
                batch = prepare_batch(batch)
            enhanced, aux = eval_step({k: batch[k] for k in MODEL_KEYS if k in batch})
            enhanced = np.asarray(_host(enhanced), np.float64)
            gt = np.asarray(_host(batch["gt"]), np.float64)
            mixed = np.asarray(_host(batch["mixed"]), np.float64)
            noises = np.asarray(_host(batch["noises"]), np.float64)

            m_sisnr.update(enhanced, gt)
            pool.submit_sdr("sdr", enhanced, gt)
            # PESQ on the valid extent only (padding would dilute the score)
            row_lens = _host(batch["sp_len"]) if "sp_len" in batch else None
            pool.submit_pesq("pesq", enhanced, gt, lengths=row_lens)
            if need_prev:
                m_sisnr_prev.update(mixed, gt)
                pool.submit_sdr("sdr_prev", mixed, gt)
                pool.submit_pesq("pesq_prev", mixed, gt, lengths=row_lens)

            ok = np.ones(len(enhanced), np.int32)
            gt_score = si_snr_numpy(enhanced, gt)
            for c in range(noises.shape[-1]):
                ok &= (gt_score >= si_snr_numpy(enhanced, noises[:, :, c])).astype(np.int32)
            accs.append(ok)

            if generate_speech and save_dir is not None:
                _dump_wavs(save_dir, dir_name, test_dataset, batch["names"], row_lens,
                           {"gts": gt, "preds": enhanced, "mixed": mixed}, sr)

            seen += len(enhanced)
            if verbose and bi % 100 == 0:
                print(f"******** Test : {seen} / {total} ********")

        if need_prev:
            prev = {
                "si_snr_prev": m_sisnr_prev.compute(),
                "sdr_prev": pool.mean("sdr_prev"),
                "pesq_prev": pool.mean("pesq_prev"),
                "n": seen,
            }
            store_prev_cache(prev_cache_dir, cache_key, prev)
        else:
            prev = prev_cached
            if verbose:
                print(f"## prev (mixture-side) metrics restored from cache "
                      f"[{cache_key}] (n={prev.get('n')})")

        pesq = pool.mean("pesq")
        results = {
            "si_snr": m_sisnr.compute(),
            "sdr": pool.mean("sdr"),
            "si_snr_i": m_sisnr.compute() - prev["si_snr_prev"],
            "sdr_i": pool.mean("sdr") - prev["sdr_prev"],
            # P.862-scale PESQ (narrowband, 8 kHz): a spec reimplementation,
            # property-validated (eval/pesq.py docstring)
            "pesq": pesq,
            "pesq_i": pesq - prev["pesq_prev"],
            "acc": float(np.mean(np.concatenate(accs))) if accs else 0.0,
            "n": seen,
        }
    finally:
        pool.close()
    if verbose:
        print(f"## Test SI-SNR ({test_dataset}): ", results["si_snr"])
        print(f"## Test SDR ({test_dataset}): ", results["sdr"])
        print(f"## Test SI-SNR-I ({test_dataset}): ", results["si_snr_i"])
        print(f"## Test SDR-I ({test_dataset}): ", results["sdr_i"])
        print(f"## Test PESQ-p862 ({test_dataset}): ", results["pesq"])
    if save_dir is not None:
        out = os.path.join(save_dir, dir_name)
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, f"test_results_{test_dataset}.txt"), "w") as f:
            f.write(f"Test SI-SNR: {results['si_snr']}\n")
            f.write(f"Test SDR: {results['sdr']}\n")
            f.write(f"Test SI-SNR-I: {results['si_snr_i']}\n")
            f.write(f"Test SDR-I: {results['sdr_i']}\n")
            f.write(f"Test PESQ-p862: {results['pesq']}\n")
            f.write(f"Test PESQ-p862-I: {results['pesq_i']}\n")
        with open(os.path.join(out, f"acc_{test_dataset}.txt"), "w") as f:
            f.write(f"{results['acc']:.4f}\n")
    return results


def _dump_wavs(save_dir, dir_name, test_dataset, names, lens, arrays, sr):
    """Peak-normed wavs of each row's valid extent: ``arrays`` maps the
    sub-directory (gts, preds, mixed) to its host [B, T] array."""
    base = os.path.join(save_dir, dir_name, f"audio_{test_dataset}")
    for sub in arrays:
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    for k, name in enumerate(names):
        n = int(lens[k])
        for sub, arr in arrays.items():
            x = arr[k, :n].astype(np.float32)
            x = x / max(np.abs(x).max(), 1e-9) * 0.9
            write_wav(os.path.join(base, sub, name + ".wav"), x, sr)
