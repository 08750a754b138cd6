"""Prefill attention of DeepSeek-V2's multi-head latent attention (MLA).

It replaces no Pallas kernel: the JAX package has no DeepSeek-V2 encoder.
It was added for the port's dialog-history encoder
(``models/deepseek_v2.py::mla``): MLA was 48% of the history cell's device
time at 6% of its bound, most of it the attention after the projections:
fp32 scores of B H T^2 values written to device memory and passed over four
times, every (query, key) pair computed, the causal upper half and the left
padding too.

:func:`mla_attention` launches ``csrc/mla.cu``'s ``mla_prefill_bf16_kernel``
for CUDA tensors (bound by the tensor cores at the cell's shape; the scores,
probabilities and softmax statistics stay on chip, tiles with no live pair
are skipped on the device, the rope key every head shares is read once a key
tile) and takes its plain twin :func:`mla_attention_plain` for CPU tensors.
It counts its launches in ``mla_attention.launches``.

The inputs are the projections' outputs as they come, with no copy: ``q``
[B, T, H (dn + dr)] (the rope applied to each head's dr columns), ``kv`` [B,
T, H (dn + dv)] (each head's k_nope, then v), ``k_pe`` [B, T, dr] (the rope
key every head shares). The output is ``o`` [B, T, H dv], the layout
``o_proj`` reads. Masking is causal plus left padding, given on the card as
each row's first real token ``first`` [B] int32 (:func:`first_real`).

Numerics. The plain twin is the encoder's attention as it was: bf16 scores,
cast to fp32 and scaled, a finite additive bias (``MASK_BIAS``) for the mask,
an fp32 softmax, probabilities cast to bf16, P.V summed in fp32. The kernel
sums the scores in fp32 and scales them there (no bf16 rounding of the
scores), runs an online softmax in fp32 with ``exp2`` (the scale folded in),
casts p to bf16 and divides O by the row sum at the end. A pad row (no real
key at or before it) is 0 from the kernel and the mean of v from the twin:
real rows never read pad rows, so only pad rows differ.
"""

from __future__ import annotations

import torch

from cse_tpu_torch.ops import _build
from cse_tpu_torch.ops import fused_stack as fs

MASK_BIAS = -1e30
TILE = 128  # csrc/mla.cu's query and key tile
# (qk_nope, qk_rope, v_head) the kernel is instantiated for: DeepSeek-V2 /
# -Lite / V3's, and the tests' tiny widths
WIDTHS = ((128, 64, 128), (32, 16, 32))


def attention_bias(mask: torch.Tensor) -> torch.Tensor:
    """The additive fp32 bias [B, 1, T, T]: 0 where a query may read a key
    (causal, key not padding), ``MASK_BIAS`` elsewhere."""
    T = mask.shape[1]
    causal = torch.ones(T, T, dtype=torch.bool, device=mask.device).tril()
    keep = mask.bool()[:, None, None, :] & causal
    return torch.where(keep, 0.0, MASK_BIAS).float()


def first_real(mask: torch.Tensor) -> torch.Tensor:
    """Each row's first real token [B] int32 of a left-padded mask [B, T],
    computed where the mask lies (no host read)."""
    return (mask.shape[1] - mask.sum(dim=1)).to(torch.int32)


def mask_of_first(first: torch.Tensor, T: int) -> torch.Tensor:
    """The left-padded mask [B, T] whose rows start at ``first``."""
    return torch.arange(T, device=first.device)[None] >= first[:, None]


def tile_counts(first: torch.Tensor, T: int, tile: int = TILE) -> tuple[torch.Tensor, torch.Tensor]:
    """(run, skipped): the (query tile, key tile) pairs of the [T/tile]^2
    grid of every row that the kernel computes, and those it skips (above
    the diagonal, or wholly before the row's first real token), summed over
    the rows; device tensors where ``first`` lies, nothing read back."""
    n = -(-T // tile)
    qt = torch.arange(n, device=first.device)[None]
    f = first.long()[:, None]
    last = (qt * tile + tile).clamp(max=T) - 1  # each query tile's last row
    run = torch.where(last >= f, qt - f // tile + 1, 0).sum()
    return run, first.shape[0] * n * n - run


def mla_attention_plain(q, kv, k_pe, bias, scale: float, widths: tuple[int, int, int]) -> torch.Tensor:
    """The encoder's attention arithmetic: o [B, T, H dv] from q, kv, k_pe as
    :func:`mla_attention` takes them and the additive bias [B, 1, T, T]."""
    dn, dr, dv = widths
    B, T, _ = q.shape
    H = kv.shape[-1] // (dn + dv)
    q = q.view(B, T, H, dn + dr).transpose(1, 2)
    k_nope, v = kv.view(B, T, H, dn + dv).transpose(1, 2).split([dn, dv], dim=-1)
    k = torch.cat([k_nope, k_pe[:, None].expand(B, H, T, dr)], dim=-1)
    # bias + scale x scores in one fp32 pass (the bf16 product is promoted before the scale)
    s = torch.add(bias, torch.matmul(q, k.transpose(-1, -2)), alpha=scale)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    del s
    return torch.matmul(p, v).transpose(1, 2).reshape(B, T, H * dv)


def _check(q, kv, k_pe, first, widths):
    if tuple(widths) not in WIDTHS:
        raise ValueError(f"mla_attention: widths (qk_nope, qk_rope, v_head) {tuple(widths)} have no kernel "
                         f"(csrc/mla.cu is instantiated for {WIDTHS})")
    dn, dr, dv = widths
    for t, name in ((q, "q"), (kv, "kv"), (k_pe, "k_pe")):
        fs._check(t, name, torch.bfloat16, 3)
    fs._check(first, "first", torch.int32, 1)
    B, T, qw = q.shape
    H = qw // (dn + dr)
    want = {"q": (B, T, H * (dn + dr)), "kv": (B, T, H * (dn + dv)), "k_pe": (B, T, dr), "first": (B,)}
    for t, name in ((q, "q"), (kv, "kv"), (k_pe, "k_pe"), (first, "first")):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"mla_attention: {name} is {tuple(t.shape)}, want {want[name]}")
    if any(t.data_ptr() % 16 for t in (q, kv, k_pe)):
        raise ValueError("mla_attention needs 16-byte aligned q, kv and k_pe")
    return B, T, H


def mla_attention(q, kv, k_pe, first, scale: float, widths: tuple[int, int, int]) -> torch.Tensor:
    """o [B, T, H dv]: causal attention of q over keys (k_nope | k_pe) and
    values v, query i of row b reading keys ``first[b]`` .. i. On CUDA
    ``mla_prefill_bf16_kernel`` (bf16 in and out; pad rows 0); on the CPU
    the plain twin under the same mask."""
    if not fs._route(q, kv, k_pe, first):
        return mla_attention_plain(q, kv, k_pe, attention_bias(mask_of_first(first, q.shape[1])), scale, widths)
    B, T, H = _check(q, kv, k_pe, first, widths)
    dn, dr, dv = widths
    o = torch.empty(B, T, H * dv, dtype=torch.bfloat16, device=q.device)
    err = _build.library().cse_mla_prefill(q.data_ptr(), kv.data_ptr(), k_pe.data_ptr(), first.data_ptr(),
                                           o.data_ptr(), B, T, H, dn, dr, dv, float(scale), fs._stream())
    fs._check_launch("mla_prefill", err)
    mla_attention.launches += 1
    return o


mla_attention.launches = 0

INFO_KEYS = ("threads", "smem_bytes", "registers", "local_bytes", "blocks_per_sm")


def mla_attention_info(widths: tuple[int, int, int] = WIDTHS[0]) -> dict:
    """How the kernel launches at ``widths``: threads and dynamic shared
    bytes a block, registers and local-memory bytes a thread, resident
    blocks per SM."""
    return _build.query("cse_mla_prefill_info", INFO_KEYS, *widths)
