"""Flash-style multi-head self-attention with a hand-written backward.

Port of ``cse_tpu/ops/attention.py``: the TPU kernel pair ``_fwd_kernel``
(:38) and ``_bwd_kernel`` (:59) under one ``jax.custom_vjp``. Here the pair
is :class:`FlashAttention`, a ``torch.autograd.Function`` whose forward
saves ``(q, k, v, o, lse)`` and whose backward recomputes the probabilities
from ``lse``. On Hopper both run as the kernels of ``csrc/attention.cu``.

Each kernel has a wrapper (:func:`flash_fwd`, :func:`flash_bwd`) that
launches it for CUDA tensors, takes its plain PyTorch version
(:func:`flash_fwd_plain`, :func:`flash_bwd_plain`) for CPU tensors, and
raises for anything else; each wrapper counts its launches in its
``launches`` attribute.

Numerics (those of the TPU kernels): s = (q . k^T) * scale with q, k upcast
to fp32 and the scale applied after the product; p = exp(s - max); the
division by sum p comes before the PV product, on p rounded to v's dtype;
o (fp32 accumulation) is written in q's dtype and lse = max + log(sum p) in
fp32. The backward is fp32 throughout on upcast operands: p = exp(s - lse),
delta = rowsum(do * o), ds = p * (dp - delta) * scale, dq = ds . k,
dk = ds^T . q, dv = p^T . do, each rounded to q's dtype. The JAX wrapper
pads L to a multiple of 128 for the TPU's lanes; the port needs no padding
(the kernels mask keys past L themselves).
"""

from __future__ import annotations

import math

import torch

from cse_tpu_torch.ops import _build
from cse_tpu_torch.ops import fused_stack as fs
from cse_tpu_torch.ops.fused_stack import wide

# head widths the flash kernels are instantiated for (csrc/common.cuh's FlashHeadWidths)
HEAD_WIDTHS = (4, 8, 16, 32, 48, 64)
STRIP_MAX_L = 256  # csrc/attention.cu's STRIP_MAX_L: the bf16 kernels' one-pass route


def _chunks(bh: int, L: int):
    """Slices of the flattened batch-head axis whose [n, L, L] fp32 score
    tensors stay near 512 MB."""
    step = max(1, (1 << 27) // (L * L))
    return [slice(i, i + step) for i in range(0, bh, step)]


# ---------------------------------------------------------------- plain versions


def flash_fwd_plain(q, k, v):
    """``_fwd_kernel``'s arithmetic on q/k/v ``[B, H, L, dh]``: (o in q's
    dtype, lse ``[B, H, L]`` in the accumulation type)."""
    B, H, L, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    qf, kf, vf = (t.reshape(B * H, L, dh) for t in (q, k, v))
    acc = wide(q).dtype
    o = torch.empty(B * H, L, dh, dtype=q.dtype, device=q.device)
    lse = torch.empty(B * H, L, dtype=acc, device=q.device)
    for sl in _chunks(B * H, L):
        s = (wide(qf[sl]) @ wide(kf[sl]).transpose(-1, -2)) * scale
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        denom = p.sum(dim=-1, keepdim=True)
        o[sl] = (wide((p / denom).to(v.dtype)) @ wide(vf[sl])).to(q.dtype)
        lse[sl] = (m + torch.log(denom))[..., 0]
    return o.reshape(B, H, L, dh), lse.reshape(B, H, L)


def flash_bwd_plain(q, k, v, o, lse, do):
    """``_bwd_kernel``'s arithmetic, step by step: (dq, dk, dv) in q's dtype.
    Not autograd through :func:`flash_fwd_plain`, which would round p to v's
    dtype in dv."""
    B, H, L, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    flat = [t.reshape(B * H, L, -1) for t in (q, k, v, o, lse[..., None], do)]
    grads = [torch.empty(B * H, L, dh, dtype=q.dtype, device=q.device) for _ in range(3)]
    for sl in _chunks(B * H, L):
        qf, kf, vf, of, lf, dof = (wide(t[sl]) for t in flat)
        s = (qf @ kf.transpose(-1, -2)) * scale
        p = torch.exp(s - lf)
        dp = dof @ vf.transpose(-1, -2)
        delta = (dof * of).sum(dim=-1, keepdim=True)
        ds = p * (dp - delta) * scale
        grads[0][sl] = (ds @ kf).to(q.dtype)
        grads[1][sl] = (ds.transpose(-1, -2) @ qf).to(q.dtype)
        grads[2][sl] = (p.transpose(-1, -2) @ dof).to(q.dtype)
    return tuple(g.reshape(B, H, L, dh) for g in grads)


# ---------------------------------------------------------------- kernel wrappers


def _check_qkv(q, *others):
    if q.dtype not in fs._KERNEL_DTYPES:
        raise TypeError(f"flash attention kernels take fp32 or bf16, not {q.dtype}")
    fs._check(q, "q", None, 4)
    for i, t in enumerate(others):
        fs._check(t, f"operand {i + 1}", q.dtype, 4)
        if t.shape != q.shape:
            raise ValueError(f"operand {i + 1} is {tuple(t.shape)}, q is {tuple(q.shape)}")
    B, H, L, dh = q.shape
    fs.check_head_width(dh, "flash attention", HEAD_WIDTHS)
    if any(t.data_ptr() % 16 for t in (q, *others)):
        raise ValueError("flash attention kernels need 16-byte aligned operands")
    return B * H, L, dh


def flash_fwd(q, k, v):
    """(o, lse) of :func:`flash_fwd_plain`; the forward kernel on CUDA (bf16:
    the one-pass strip kernel for L <= 256, three passes beyond)."""
    if not fs._route(q, k, v):
        return flash_fwd_plain(q, k, v)
    bh, L, dh = _check_qkv(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    err = _build.library().cse_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        int(q.dtype == torch.bfloat16), bh, L, dh, 1.0 / math.sqrt(dh), fs._stream())
    fs._check_launch("flash_fwd", err)
    flash_fwd.launches += 1
    return o, lse


def flash_fwd_info(L: int, dh: int = 32) -> dict:
    """How :func:`flash_fwd` launches the bf16 forward at (L, dh): see
    :func:`cse_tpu_torch.ops._build.launch_info`."""
    return _build.launch_info("cse_flash_fwd_info", L, dh)


def flash_bwd(q, k, v, o, lse, do):
    """(dq, dk, dv) of :func:`flash_bwd_plain`; on CUDA the backward kernels
    (bf16: one pass for L <= 256, :func:`flash_bwd_info`; beyond, and in
    fp32, delta, then dq, then dk and dv)."""
    if not fs._route(q, k, v, o, lse, do):
        return flash_bwd_plain(q, k, v, o, lse, do)
    bh, L, dh = _check_qkv(q, k, v, o, do)
    fs._check(lse, "lse", torch.float32, 3)
    if tuple(lse.shape) != tuple(q.shape[:3]):
        raise ValueError(f"lse is {tuple(lse.shape)}, want {tuple(q.shape[:3])}")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    strip = q.dtype == torch.bfloat16 and L <= STRIP_MAX_L  # delta stays in the block
    delta = None if strip else torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    err = _build.library().cse_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
        None if delta is None else delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        int(q.dtype == torch.bfloat16), bh, L, dh, 1.0 / math.sqrt(dh), fs._stream())
    fs._check_launch("flash_bwd", err)
    flash_bwd.launches += 1
    return dq, dk, dv


def flash_bwd_info(L: int, dh: int = 32) -> dict:
    """How :func:`flash_bwd` launches the bf16 backward at (L, dh): see
    :func:`cse_tpu_torch.ops._build.launch_info` (the three-kernel route
    reports its dq kernel)."""
    return _build.launch_info("cse_flash_bwd_info", L, dh)


KERNELS = {"flash_fwd": flash_fwd, "flash_bwd": flash_bwd}


def reset_launches():
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


reset_launches()


def launches_per_step(n_attention: int, remat_layers: bool, train: bool = True) -> dict[str, int]:
    """Launches of a forward (``train=False``) or a train step over
    ``n_attention`` attention layers: the backward replays each forward once
    when the layers are rematerialised."""
    if not train:
        return {"flash_fwd": n_attention, "flash_bwd": 0}
    return {"flash_fwd": n_attention * (2 if remat_layers else 1), "flash_bwd": n_attention}


# ---------------------------------------------------------------- the function


class FlashAttention(torch.autograd.Function):
    """``_flash`` of the JAX package: the forward kernel, residuals
    (q, k, v, o, lse), and the backward kernel for dq, dk, dv."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_bwd(q, k, v, o, lse, do.to(q.dtype).contiguous())


def flash_mhsa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Fused self-attention. q/k/v: ``[B, H, L, dh]`` -> ``[B, H, L, dh]`` in
    q's dtype, differentiable in all three."""
    return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous())
