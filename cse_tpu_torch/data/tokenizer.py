"""Context tokenization with static shapes.

The reference tokenizes dialog histories with the Llama-3 BPE tokenizer,
left-padded and left-truncated (``dataset_train_CSE.py:106-109,572``). The
token budget is fixed per bucket (the port's copy of
``cse_tpu/data/tokenizer.py``, whose shapes it keeps): ``encode_batch``
left-truncates to ``max_tokens`` and left-pads to exactly
that length.

When the Llama tokenizer files aren't available locally (zero-egress
environments), ``ByteTokenizer`` provides a deterministic fallback with the
same interface so the full pipeline stays runnable end-to-end; it is NOT
checkpoint-compatible with Llama conditioning and says so loudly.
"""

from __future__ import annotations

import numpy as np


class ByteTokenizer:
    """UTF-8 byte fallback tokenizer (ids 2..257; bos=1, pad=0)."""

    pad_token_id = 0
    bos_token_id = 1
    vocab_size = 258
    is_fallback = True

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = [b + 2 for b in text.encode("utf-8")]
        return ([self.bos_token_id] + ids) if add_bos else ids

    def decode(self, ids) -> str:
        return bytes(i - 2 for i in ids if i >= 2).decode("utf-8", errors="replace")


class HFTokenizer:
    """transformers AutoTokenizer wrapper with the reference's settings."""

    is_fallback = False

    def __init__(self, path: str, auth_token: str | None = None):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(path, token=auth_token or None)
        self.tok.pad_token_id = self.tok.eos_token_id
        self.tok.padding_side = "left"
        self.tok.truncation_side = "left"
        self.pad_token_id = self.tok.pad_token_id
        self.bos_token_id = self.tok.bos_token_id
        self.vocab_size = len(self.tok)

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        return self.tok(text, add_special_tokens=add_bos).input_ids

    def decode(self, ids) -> str:
        return self.tok.decode(ids, skip_special_tokens=True)


def load_tokenizer(path: str, auth_token: str | None = None, allow_fallback: bool = True):
    import os

    os.environ.setdefault("HF_HUB_OFFLINE", "1")  # zero-egress: never retry hub
    try:
        if not os.path.isdir(path):
            raise FileNotFoundError(f"tokenizer path {path!r} is not a local directory")
        return HFTokenizer(path, auth_token)
    except Exception as e:
        if not allow_fallback:
            raise
        import sys

        print(
            f"[cse_tpu_torch] WARNING: could not load tokenizer from {path!r} ({e}); "
            "using ByteTokenizer fallback — NOT compatible with released "
            "Llama-conditioned checkpoints.",
            file=sys.stderr,
        )
        return ByteTokenizer()


def encode_batch(
    tokenizer, texts: list[str], max_tokens: int,
    buckets: tuple[int, ...] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Tokenize -> (ids [B, W], mask [B, W]) int32.

    Left-truncated to ``max_tokens``, left-padded with pad_token_id — the
    reference's padding_side/truncation_side='left' (``dataset_train_CSE.py:
    106-109,572``). The reference pads dynamically to the batch max; a fully
    dynamic width would recompile the jitted step per batch, so the static
    width W is either ``max_tokens`` (default) or, with ``buckets``, the
    smallest bucket that holds the longest row — one compiled program per
    bucket, and short dialog histories skip most of the frozen-LLM prefill
    cost (PERF.md "context-length bucketing").
    """
    B = len(texts)
    rows = [tokenizer.encode(t)[-max_tokens:] for t in texts]
    width = max_tokens
    if buckets:
        longest = max((len(r) for r in rows), default=1)
        fitting = [b for b in sorted(buckets) if b >= longest]
        width = min(fitting[0], max_tokens) if fitting else max_tokens
    ids = np.full((B, width), tokenizer.pad_token_id, np.int32)
    mask = np.zeros((B, width), np.int32)
    for i, toks in enumerate(rows):
        ids[i, width - len(toks):] = toks
        mask[i, width - len(toks):] = 1
    return ids, mask
