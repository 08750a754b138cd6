"""Shape buckets for the dual-path separator (port of ``cse_tpu/ops/buckets.py``).

``aligned_bucket`` picks the largest T' <= T whose inter sequence length
S + ctx sits just under a multiple of 128. The port keeps the rule so that it
serves the same buckets as the reference.
"""

from __future__ import annotations

from cse_tpu_torch.ops.segmentation import segment_shapes


def frames_for_samples(T: int, kernel: int = 16, stride: int = 8) -> int:
    return (T - kernel) // stride + 1


def inter_len(T: int, K: int = 250, ctx: int = 1, kernel: int = 16, stride: int = 8) -> int:
    _, S = segment_shapes(frames_for_samples(T, kernel, stride), K)
    return S + ctx


def aligned_bucket(
    T: int, K: int = 250, ctx: int = 1, kernel: int = 16, stride: int = 8
) -> int:
    """Largest T' <= T whose inter sequence length fits a 128 tile.

    Returns T unchanged when it is already aligned or when no aligned bucket
    exists within 10% below T.
    """

    def pad_waste(t: int) -> int:
        il = inter_len(t, K, ctx, kernel, stride)
        return ((il + 127) // 128) * 128 - il

    if pad_waste(T) <= 1:
        return T
    t = T - stride
    floor = int(T * 0.9)
    while t >= floor:
        if pad_waste(t) <= 1:
            return t
        t -= stride
    return T
