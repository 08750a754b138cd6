"""Corpus indexing and dialog-context assembly.

Pure host-side metadata logic mirroring the reference ``CSEDataset``
(``src/data/dataset_train_CSE.py``), decoupled from audio decode and from
batching so it can feed the threaded loader:

* train lists: DailyTalk dialogs from ``data/DailyTalk/train_dialog.txt``,
  SpokenWoz directory scan, TEDLIUM glob (``dataset_train_CSE.py:118-137``)
* eval lists: premixed ``{mode}/{mixed,gt}[_3speaker]`` pairs, test-set
  context-length filter (>=5 DailyTalk / >=10 others), SpokenWoz val
  subsample to 1000 (``:139-162``)
* context text: ``'Speaker {i%2}: '`` prefixes (none for TEDLIUM),
  whitespace-collapse + ``[unk]`` removal, literal ``'/n'`` join (NOT a
  newline — faithful quirk, ``:322``), trailing next-speaker prompt, and the
  train-time random context window (``:300-322``)
* H-ContExt enrollment sources (``:375-391``)
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
import random

_RE_WS = re.compile(r"\s+")


def text_process(text: str) -> str:
    """``[unk]`` removal + whitespace collapse (reference ``:15-18``)."""
    return _RE_WS.sub(" ", text.replace("[unk]", "")).strip()


@dataclasses.dataclass
class CorpusPaths:
    dailytalk: str = "./DailyTalk_processed_16k"
    spokenwoz: str = "./Spokenwoz_preprocessed"
    tedlium: str = "./TEDLIUM_release-3_CSF"
    demand: str = "./DEMAND"
    lists_root: str = "./data"  # static split/mixture lists

    def root(self, corpus: str) -> str:
        return {
            "dailytalk": self.dailytalk,
            "spokenwoz": self.spokenwoz,
            "tedlium": self.tedlium,
        }[corpus]


def build_train_list(paths: CorpusPaths, corpus: str) -> list[str]:
    root = paths.root(corpus)
    if corpus == "dailytalk":
        out: list[str] = []
        with open(os.path.join(paths.lists_root, "DailyTalk", "train_dialog.txt")) as f:
            for line in f:
                d = os.path.join(root, "train", line.strip())
                out.extend(sorted(glob.glob(os.path.join(d, "*.wav"))))
        return out
    if corpus == "spokenwoz":
        out = []
        for dialog in sorted(os.listdir(os.path.join(root, "train"))):
            out.extend(
                sorted(glob.glob(os.path.join(root, "train", dialog, "*.wav")))
            )
        return out
    return sorted(glob.glob(os.path.join(root, "train", "*", "*.wav")))


def build_eval_list(
    paths: CorpusPaths,
    corpus: str,
    mode: str,
    num_test_mix: int = 2,
    seed: int | None = None,
) -> tuple[list[str], list[str]]:
    """Premixed eval pairs -> (mix_paths, gt_paths).

    ``seed`` pins the SpokenWoz val subsample (the reference draws it from
    global numpy state with no fixed seed — documented quirk SURVEY.md §7.4;
    we default to seeded for reproducibility).
    """
    assert mode in ("val", "test")
    root = paths.root(corpus)
    mix_name = "mixed" if num_test_mix == 2 else "mixed_3speaker"
    gt_name = "gt" if num_test_mix == 2 else "gt_3speaker"
    test_limit = 5 if corpus == "dailytalk" else 10

    mix_paths, gt_paths = [], []
    for f in sorted(glob.glob(os.path.join(root, mode, mix_name, "*.txt"))):
        if mode == "test":
            with open(f) as txt:
                if len(txt.readlines()) < test_limit:
                    continue
        mix_paths.append(f[:-4] + ".wav")
        parts = os.path.normpath(f).split(os.sep)
        parts[-2] = gt_name
        gt_paths.append(os.sep.join(parts)[:-4] + ".wav")

    if corpus == "spokenwoz" and mode == "val" and len(mix_paths) > 1000:
        rng = random.Random(seed if seed is not None else 0)
        idx = rng.sample(range(len(mix_paths)), 1000)
        mix_paths = [mix_paths[i] for i in idx]
        gt_paths = [gt_paths[i] for i in idx]
    return mix_paths, gt_paths


def noise_paths_for(gt_path: str, num_test_mix: int) -> list[str]:
    """Interferer wavs alongside a gt wav (reference ``:329-332``).

    Only the gt *directory component* is rewritten (the reference's
    whole-path ``.replace('gt', ...)`` corrupts paths whose parents happen
    to contain ``'gt'``)."""
    parts = os.path.normpath(gt_path).split(os.sep)
    noise_names = (
        ["noise"] if num_test_mix == 2 else ["noise_1", "noise_2"]
    )
    out = []
    for name in noise_names:
        p = list(parts)
        p[-2] = p[-2].replace("gt", name, 1)
        out.append(os.sep.join(p))
    return out


def demand_noise_list(paths: CorpusPaths) -> list[str]:
    return sorted(glob.glob(os.path.join(paths.demand, "*", "*.wav")))


def assemble_context(
    wav_path: str,
    corpus: str,
    mode: str,
    context_length: int = 0,
    max_context_train: int = 300,
    rng: random.Random | None = None,
) -> str:
    """Build the dialog-history string for one utterance.

    ``context_length``: eval-time 0 = full history, -1 = none, n>0 = last n
    turns; training draws a random window of 1..min(len, max_context_train)
    turns (reference ``:300-322,339-363``).
    """
    txt_path = os.path.splitext(wav_path)[0] + ".txt"
    with open(txt_path) as f:
        lines = f.readlines()

    tedlium = corpus == "tedlium"
    context: list[str] = []
    spk = 0
    if lines:
        for spk, line in enumerate(lines):
            t = text_process(line.strip())
            context.append(t if tedlium else f"Speaker {spk % 2}: " + t)
        if mode == "train":
            rng = rng or random
            window = rng.randint(1, min(len(context), max_context_train))
            context = context[-window:]
        elif context_length > 0:
            context = context[-context_length:]
        elif context_length == -1:
            context = []
    context.append("" if tedlium else f"Speaker {(spk + 1) % 2}: ")
    return "/n".join(context)  # literal '/n' — faithful to the reference


def enrollment_path(
    wav_path: str, corpus: str, mode: str, paths: CorpusPaths, num_test_mix: int = 2
) -> str | None:
    """Eval-time enrollment audio for H-ContExt (reference ``:380-391``).

    Returns None when the enrollment is a crop of the gt itself (spokenwoz /
    one_sec mode).
    """
    base = os.path.basename(wav_path)
    if corpus == "tedlium":
        spk = base.split("-")[0]
        gt_dir = "gt" if num_test_mix == 2 else "gt_3speaker"
        cands = sorted(
            glob.glob(os.path.join(paths.tedlium, mode, gt_dir, f"{spk}*.wav"))
        )
        return cands[0] if cands else None
    if corpus == "dailytalk":
        spk = base.split("_")[2]
        register = {
            "0": os.path.join(
                paths.dailytalk, "test/gt/237_0_0_d237-72_4_1_d72-3.9282.wav"
            ),
            "1": os.path.join(
                paths.dailytalk, "test/gt/32_0_1_d32-1405_0_0_d1405-3.9264.wav"
            ),
        }
        return register.get(spk)
    return None
