"""Synthetic corpus generator.

Builds a miniature DailyTalk-shaped corpus on disk (dialog dirs of per-
utterance 16 kHz wavs + cumulative-context txts, premixed val/test dirs,
split lists, a fake DEMAND tree) so the ENTIRE real pipeline — indexers,
loaders, device synthesis, eval protocol, CLIs — runs end-to-end in tests
and ``--synthetic_smoke`` mode without the licensed corpora.
"""

from __future__ import annotations

import os
import random

import numpy as np

from cse_tpu_torch.data.audio_io import peak_normalize_np, write_wav

_WORDS = (
    "the of and to in is that it was for on are as with his they at be this "
    "have from or had by word but not what all were we when your can said "
    "there use an each which she do how their if will up other about out many"
).split()


def _utterance(rng: np.random.Generator, seconds: float, sr: int = 16000) -> np.ndarray:
    """Speech-ish test signal: a few random harmonics with an envelope."""
    n = int(seconds * sr)
    t = np.arange(n) / sr
    f0 = rng.uniform(90, 250)
    x = np.zeros(n, np.float32)
    for h in range(1, 5):
        x += rng.uniform(0.2, 1.0) * np.sin(
            2 * np.pi * f0 * h * t + rng.uniform(0, 6.28)
        ).astype(np.float32)
    env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(1.5, 4.0) * t)).astype(np.float32)
    x = x * env + 0.01 * rng.standard_normal(n).astype(np.float32)
    return peak_normalize_np(x)


def _sentence(rng: random.Random, n_words: int = 6) -> str:
    return " ".join(rng.choice(_WORDS) for _ in range(n_words))


_CORPUS_DIRS = {
    "dailytalk": "DailyTalk_processed_16k",
    "spokenwoz": "Spokenwoz_preprocessed",
    "tedlium": "TEDLIUM_release-3_CSF",
}


def make_synthetic_corpus(
    root: str,
    n_dialogs: int = 4,
    turns_per_dialog: int = 8,
    n_eval: int = 6,
    seconds: tuple[float, float] = (1.0, 3.0),
    seed: int = 0,
    num_test_mix: int = 2,
    corpus: str = "dailytalk",
) -> dict:
    """Create the corpus; returns paths dict for CorpusPaths/flags.

    ``corpus`` selects the on-disk layout convention: DailyTalk (dialog dirs
    listed in ``train_dialog.txt``), SpokenWoz (directory scan of
    ``train/{dialog}/``, >=10-turn eval contexts), or TEDLIUM (talk dirs,
    ``{spk}-...`` wav names, no-Speaker-prefix contexts) — matching what
    ``cse_tpu_torch.data.datasets`` expects of each (reference
    ``dataset_train_CSE.py:118-162``).
    """
    assert corpus in _CORPUS_DIRS, corpus
    rng = np.random.default_rng(seed)
    prng = random.Random(seed)
    data_root = os.path.join(root, _CORPUS_DIRS[corpus])
    lists_root = os.path.join(root, "data")
    if corpus == "dailytalk":
        os.makedirs(os.path.join(lists_root, "DailyTalk"), exist_ok=True)
    else:
        os.makedirs(lists_root, exist_ok=True)
    # test-set context filter: >=5 lines (dailytalk) / >=10 (others)
    ctx_lines = 6 if corpus == "dailytalk" else 11

    dialog_names = []
    all_train = []
    for d in range(n_dialogs):
        dname = str(d) if corpus != "tedlium" else f"Talk{d}"
        ddir = os.path.join(data_root, "train", dname)
        os.makedirs(ddir, exist_ok=True)
        dialog_names.append(dname)
        history: list[str] = []
        for t in range(turns_per_dialog):
            wav = _utterance(rng, prng.uniform(*seconds))
            stem = (
                f"Spk{d}-{t}" if corpus == "tedlium" else f"{t}_{t % 2}_d{d}"
            )
            base = os.path.join(ddir, stem)
            write_wav(base + ".wav", wav, 16000)
            with open(base + ".txt", "w") as f:
                f.write("\n".join(history))
            history.append(_sentence(prng))
            all_train.append(base + ".wav")
    if corpus == "dailytalk":
        with open(
            os.path.join(lists_root, "DailyTalk", "train_dialog.txt"), "w"
        ) as f:
            f.write("\n".join(dialog_names) + "\n")

    # premixed eval dirs (val + test), built with the reference mixing math;
    # noise dirs follow the reference's gt-path .replace('gt', 'noise_i')
    # convention, i.e. 'noise' (2-spk) / 'noise_{1,2}_3speaker' (3-spk)
    mix_name = "mixed" if num_test_mix == 2 else "mixed_3speaker"
    gt_name = "gt" if num_test_mix == 2 else "gt_3speaker"
    noise_dirs = (
        ["noise"]
        if num_test_mix == 2
        else [gt_name.replace("gt", "noise_1"), gt_name.replace("gt", "noise_2")]
    )
    for mode in ("val", "test"):
        for sub in [mix_name, gt_name] + noise_dirs:
            os.makedirs(os.path.join(data_root, mode, sub), exist_ok=True)
        for i in range(n_eval):
            sig = _utterance(rng, prng.uniform(*seconds))
            n = len(sig)
            noises = []
            for _ in range(num_test_mix - 1):
                noi = _utterance(rng, prng.uniform(*seconds))
                noises.append(np.pad(noi, (0, max(0, n - len(noi))))[:n])
            name = (
                f"Spk{i}-0-mix" if corpus == "tedlium" else f"{i}_0_0_d{i}-mix"
            )
            if num_test_mix == 2:
                snr = prng.uniform(-5, 5)
                g = np.sqrt(
                    10 ** (-snr / 10) * np.mean(sig**2)
                    / max(np.mean(noises[0] ** 2), 1e-12)
                )
                a, b = np.sqrt(1 / (1 + g * g)), np.sqrt(g * g / (1 + g * g))
                mixed = a * sig + b * noises[0]
                stems = [sig * a, noises[0] * b]
            else:
                gains = [
                    np.sqrt(
                        10 ** (-prng.uniform(-5, 5) / 10) * np.mean(sig**2)
                        / max(np.mean(nz**2), 1e-12)
                    )
                    for nz in noises
                ]
                scaled = [g * nz for g, nz in zip(gains, noises)]
                mixed = sig + sum(scaled)
                stems = [sig] + scaled
            scale = 0.9 / max(np.abs(mixed).max(), 1e-12)
            write_wav(
                os.path.join(data_root, mode, mix_name, name + ".wav"),
                mixed * scale, 16000,
            )
            write_wav(
                os.path.join(data_root, mode, gt_name, name + ".wav"),
                stems[0] * scale, 16000,
            )
            for nd, stem in zip(noise_dirs, stems[1:]):
                write_wav(
                    os.path.join(data_root, mode, nd, name + ".wav"),
                    stem * scale, 16000,
                )
            # context txt next to the mixed wav (>= test_limit lines)
            with open(
                os.path.join(data_root, mode, mix_name, name + ".txt"), "w"
            ) as f:
                f.write("\n".join(_sentence(prng) for _ in range(ctx_lines)))

    # fake DEMAND tree
    demand_root = os.path.join(root, "DEMAND")
    os.makedirs(os.path.join(demand_root, "DKITCHEN"), exist_ok=True)
    for i in range(2):
        write_wav(
            os.path.join(demand_root, "DKITCHEN", f"ch{i:02d}.wav"),
            0.3 * rng.standard_normal(16000 * 4).astype(np.float32), 16000,
        )

    return {
        f"{corpus}_data_path": data_root,
        "acoustic_noise_path": demand_root,
        "lists_root": lists_root,
    }
