"""Dual-path chunking: 50%-overlap segmentation and its overlap-add inverse.

Port of ``cse_tpu/ops/segmentation.py``, channels-last like the reference:
a frame sequence ``[B, L, N]`` becomes overlapped chunks ``[B, S, K, N]``
(chunk length K, hop K//2) and folds back with overlap-add.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def segment_shapes(L: int, K: int) -> tuple[int, int]:
    """Return (gap, S): trailing pad and chunk count for frame length L.

    ``gap = K - (P + L % K) % K`` with hop P = K // 2; the padded signal of
    length ``L + gap + 2P`` yields ``S = (L + gap) / P + 1`` chunks.
    """
    P = K // 2
    gap = K - (P + L % K) % K
    S = (L + gap) // P + 1
    return gap, S


def segment(x: torch.Tensor, K: int) -> tuple[torch.Tensor, int]:
    """Split ``x [B, L, N]`` into 50%-overlapped chunks ``[B, S, K, N]``.

    Chunk s covers padded frames ``[s*P, s*P + K)`` of ``[0_P, x, 0_(gap+P)]``.
    """
    B, L, N = x.shape
    P = K // 2
    gap, S = segment_shapes(L, K)
    x = F.pad(x, (0, 0, P, gap + P))
    Lp = L + gap + 2 * P
    even = x[:, : Lp - P].reshape(B, S // 2, K, N)
    odd = x[:, P:].reshape(B, S // 2, K, N)
    return torch.stack([even, odd], dim=2).reshape(B, S, K, N), gap


def overlap_add(y: torch.Tensor, gap: int) -> torch.Tensor:
    """Inverse of :func:`segment`: fold ``[B, S, K, N]`` back to ``[B, L, N]``."""
    B, S, K, N = y.shape
    P = K // 2
    even = y[:, 0::2].reshape(B, (S // 2) * K, N)[:, P:]
    odd = y[:, 1::2].reshape(B, (S // 2) * K, N)[:, : (S // 2) * K - P]
    out = even + odd
    if gap > 0:
        out = out[:, :-gap]
    return out
