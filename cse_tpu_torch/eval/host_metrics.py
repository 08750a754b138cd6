"""Asynchronous host-side eval metrics: process pool + prev-metric cache.

The port's copy of ``cse_tpu/eval/host_metrics.py`` (the same numpy code, so
the same values and the same cache keys).

The eval protocol (reference ``test.py:155-310``) is device-bound by design —
the separator runs 250-700x realtime on one chip — but our added PESQ column
(``eval/pesq.py``, pure numpy, ~0.24 s per 15 s utterance pair) and the
length-512 Toeplitz SDR solve are host work that, run synchronously in the
consumer thread, serializes with the device and dominates large test sets
(SpokenWoz test = 35k mixtures -> hours of idle device time).

Two fixes, both protocol-neutral:

* :class:`HostMetricsPool` — per-utterance PESQ and per-batch SDR jobs run on
  a ``ProcessPoolExecutor`` (spawn context: workers import numpy/scipy only,
  never the parent's CUDA context), submitted as results stream out of the
  device loop and gathered once at the end. On an n-core eval host this
  divides host-metric wall-clock by ~n and overlaps it with the device.
* prev-metric cache — the mixture-side ("prev") SI-SNR/SDR/PESQ accumulations
  depend only on the released test set (mixed, gt, lengths), not on the model
  under eval, yet were recomputed on every evaluation. ``prev_cache_key``
  fingerprints the loader's exact row set + rates; ``load_prev_cache`` /
  ``store_prev_cache`` persist the accumulated sums as JSON so re-evals of
  new checkpoints skip the mixture side entirely.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from concurrent.futures import Future, ProcessPoolExecutor

import numpy as np

_CACHE_VERSION = 1  # bump when pesq/sdr implementations change numerically


# ---------------------------------------------------------------------------
# worker functions (module-level: picklable under the spawn context; they
# import lazily so workers never pull in torch)
# ---------------------------------------------------------------------------

def _pesq_rows(gt_rows, enh_rows, sr: int) -> tuple[float, int]:
    """Sum of P.862-scale scores over rows (+ scored count; short rows skip)."""
    from cse_tpu_torch.eval.pesq import pesq_nb

    total, count = 0.0, 0
    for g, e in zip(gt_rows, enh_rows):
        if sr != 8000:
            from scipy.signal import resample_poly

            d = math.gcd(8000, sr)
            e = resample_poly(e, 8000 // d, sr // d)
            g = resample_poly(g, 8000 // d, sr // d)
        try:
            total += pesq_nb(g, e)
        except ValueError:
            continue  # too-short rows don't poison the mean
        count += 1
    return total, count


def _sdr_rows(pred, target) -> tuple[float, int]:
    from cse_tpu_torch.eval.metrics import sdr_numpy

    vals = sdr_numpy(pred, target)
    return float(np.sum(vals)), int(np.size(vals))


class HostMetricsPool:
    """Streams PESQ/SDR jobs to worker processes; gathers sums at the end.

    ``submit_pesq(name, ...)`` / ``submit_sdr(name, ...)`` enqueue work under
    a named accumulator; ``mean(name)`` blocks on that accumulator's futures
    and returns the running mean (NaN when nothing scored). With
    ``workers=0`` every job runs synchronously in-process (deterministic
    fallback; also the automatic degradation when the executor can't start,
    e.g. sandboxed environments without POSIX semaphores).
    """

    def __init__(self, sr: int, workers: int | None = None):
        self.sr = int(sr)
        if workers is None:
            workers = min(os.cpu_count() or 1, 8)
        self._pool = None
        if workers > 0:
            try:
                import multiprocessing

                self._pool = ProcessPoolExecutor(
                    max_workers=workers,
                    mp_context=multiprocessing.get_context("spawn"),
                )
            except Exception:
                self._pool = None
        self._jobs: dict[str, list[Future]] = {}

    def _run(self, name: str, fn, *args) -> None:
        jobs = self._jobs.setdefault(name, [])
        if self._pool is not None:
            try:
                jobs.append(self._pool.submit(fn, *args))
                return
            except Exception:  # broken pool: degrade to sync for the rest
                self._pool = None
        f: Future = Future()
        f.set_result(fn(*args))
        jobs.append(f)

    def submit_pesq(self, name: str, enhanced, gt, lengths=None, rows_per_job: int = 4):
        """PESQ over batch rows, trimmed to ``lengths``, split into small jobs
        so utterances of one batch spread across workers."""
        enhanced = np.atleast_2d(np.asarray(enhanced, np.float64))
        gt = np.atleast_2d(np.asarray(gt, np.float64))
        rows = []
        for k, (e, g) in enumerate(zip(enhanced, gt)):
            if lengths is not None:
                n = int(lengths[k])
                e, g = e[:n], g[:n]
            rows.append((g.copy(), e.copy()))
        for j in range(0, len(rows), rows_per_job):
            chunk = rows[j : j + rows_per_job]
            self._run(name, _pesq_rows, [c[0] for c in chunk],
                      [c[1] for c in chunk], self.sr)

    def submit_sdr(self, name: str, pred, target):
        self._run(name, _sdr_rows,
                  np.asarray(pred, np.float64), np.asarray(target, np.float64))

    def sums(self, name: str) -> tuple[float, int]:
        total, count = 0.0, 0
        for f in self._jobs.get(name, ()):
            t, c = f.result()
            total += t
            count += c
        return total, count

    def mean(self, name: str) -> float:
        total, count = self.sums(name)
        return total / count if count else float("nan")

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---------------------------------------------------------------------------
# mixture-side ("prev") metric cache
# ---------------------------------------------------------------------------

def prev_cache_key(loader, sr: int, limit_batches: int | None) -> str:
    """Fingerprint of everything the prev metrics depend on: the exact eval
    row set (mix/gt paths in order), the padded extent (t16 — SI-SNR/SDR run
    over padded rows), sample rate, and the evaluated row count."""
    n_rows = len(loader.mix_paths)
    if limit_batches is not None:
        n_rows = min(n_rows, limit_batches * loader.B)
    h = hashlib.sha256()
    h.update(f"v{_CACHE_VERSION}|{loader.corpus}|{loader.mode}|{sr}|".encode())
    h.update(f"{loader.cfg.t16}|{n_rows}|".encode())
    for mp, gp in zip(loader.mix_paths[:n_rows], loader.gt_paths[:n_rows]):
        h.update(str(mp).encode())
        h.update(b"|")
        h.update(str(gp).encode())
        h.update(b"\n")
    return h.hexdigest()[:32]


def load_prev_cache(cache_dir: str | None, key: str) -> dict | None:
    if not cache_dir:
        return None
    path = os.path.join(cache_dir, f"prev_{key}.json")
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return data if data.get("key") == key else None


def store_prev_cache(cache_dir: str | None, key: str, values: dict) -> None:
    if not cache_dir:
        return
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"prev_{key}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"key": key, **values}, f)
    os.replace(tmp, path)
