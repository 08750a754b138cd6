"""Eval-time enrollment embeddings for H-ContExt (shared by
``python -m cse_tpu_torch.test_HContExt`` and the trainer's validation).

Port of ``cse_tpu/eval/enrollment.py``. Reference rules
(``dataset_train_CSE.py:375-391``, mode != 'train'):
* dailytalk: fixed per-speaker register wavs from the test gt set
* tedlium:   first gt wav of the same speaker in the current mode
* spokenwoz / ``--one_sec``: a random 1 s crop of the gt itself
The full register/candidate wav is encoded (no truncation), with its true
length passed to the speaker encoder's masking. The crop offsets come from
numpy's generator seeded with ``(seed, crc32(name))``, so both packages draw
the same offsets.
"""

from __future__ import annotations

import os
import zlib

import numpy as np
import torch

from cse_tpu_torch.data import datasets as ds
from cse_tpu_torch.data.audio_io import read_wav
from cse_tpu_torch.models.speaker_encoder import encode_speaker


def eval_enrollment_embeddings(
    batch: dict,
    corpus: str,
    mode: str,
    paths: ds.CorpusPaths,
    encoder,
    num_test_mix: int = 2,
    seed: int = 0,
    one_sec: bool = False,
) -> torch.Tensor:
    """[B] eval batch (an ``EvalLoader`` batch: host ``gt16k`` / ``gt16k_len``,
    ``names``, ``paths``) -> speaker embeddings [B, 1, 192] from one
    ``encoder`` call on the encoder's device."""
    enroll: list[np.ndarray] = []
    for k in range(len(batch["names"])):
        wav16 = None
        if not one_sec and corpus in ("tedlium", "dailytalk"):
            p = ds.enrollment_path(batch["paths"][k], corpus, mode, paths, num_test_mix)
            if p and os.path.exists(p):
                wav16, _ = read_wav(p)
        if wav16 is None:
            # a 1 s crop of the 16 kHz gt, inside its true length; the offset
            # is seeded per item (the utterance name folded into the seed)
            rng = np.random.default_rng((seed, zlib.crc32(str(batch["names"][k]).encode())))
            gt = np.asarray(batch["gt16k"][k])
            n = int(batch["gt16k_len"][k])
            st = int(rng.integers(0, max(n - 16000, 0) + 1))
            wav16 = gt[st: min(st + 16000, max(n, 1))]
        enroll.append(np.asarray(wav16, np.float32))
    buf = np.zeros((len(enroll), max(len(e) for e in enroll)), np.float32)
    lens = np.zeros(len(enroll), np.int32)
    for k, e in enumerate(enroll):
        buf[k, : len(e)] = e
        lens[k] = len(e)
    return encode_speaker(encoder, torch.from_numpy(buf), torch.from_numpy(lens))
