"""Fused transformer layers with a hand-written backward, for training.

Port of ``cse_tpu/ops/fused_train.py``. The TPU runs a chunk of pre-LN
layers as one Pallas kernel in each direction: ``_fwd_kernel`` (:157) and
``_bwd_kernel`` (:168), which replays the chunk from its saved input and
back-propagates through it. :class:`FusedLayers` is that pair as a
``torch.autograd.Function``; :func:`fused_stack_train` runs a whole
TransformerStack through it chunk by chunk, then the stack's final LayerNorm
in plain fp32 torch.

On Hopper (``csrc/fused_stack.cu`` and ``csrc/fused_train.cu``):

* forward (and the backward's replay): per layer LN -> QKV GEMM -> attention
  -> out-proj GEMM (+residual) -> LN -> FFN1 GEMM (+relu) -> FFN2 GEMM
  (+residual), on the serving stack's kernels, the fp32 residual in device memory and
  rounded to the input's dtype at the end of each chunk (at chunk=1, after
  every layer). The replay's attention also writes each row's max and 1/z.
* backward per layer, in the TPU kernel's order FFN -> LN2 -> out-proj ->
  attention -> QKV -> LN1, with these wrappers (each counts its calls in
  ``launches``; a call may launch a kernel and the fixed-order reduction of
  its per-block partials):

  - :func:`weight_grad`: dW = A^T dY over all rows (``cse_weight_grad``: bf16
    on the wgmma + TMA loop of the serving GEMM, slabs of rows sized by
    :func:`wgrad_plan`);
  - :func:`linear_relu_grad`: dpre = where(hrelu > 0, dY W^T, 0) in cd and its
    fp32 column sums (``cse_linear_relu_grad``, the serving stack's GEMM);
  - :func:`layer_norm_backward`: dx of a LayerNorm added into the residual
    gradient, with dscale, dbias and two bias gradients (``cse_layer_norm_bwd``:
    a persistent grid sized by :func:`ln_bwd_plan`);
  - :func:`attention_backward`: dq | dk | dv in cd and their fp32 column sums
    (``cse_attention_bwd``: bf16 at L <= 256 one block per sequence and head
    in one pass, else two kernels of 64-row tiles);
  - the bias-free dX GEMMs dY W^T go through :func:`fused_stack.linear`.

Each wrapper has a plain PyTorch version beside it (``*_plain``): the CPU
path and the oracle on the card. A wrapper launches its kernel for CUDA
tensors, takes the plain version for CPU tensors, and raises otherwise.

Rounding points (those of the TPU kernel): the incoming gradient is cd;
every matmul operand is cd with fp32 accumulation (hrelu, dfo, dpre, h2, g1,
attn, dqkv, h1); dpre, g1, the residual gradient and the bias sums are fp32;
dx is written in the input's dtype; the weight gradients leave the kernels
fp32 and are rounded to the weights' cd (``:366``). Stacked LN scales and
biases are cd like every stacked tensor; the final stack LN uses the
unrounded fp32 parameters (``:432-437``).
"""

from __future__ import annotations

import functools
import math
import types
from typing import NamedTuple

import torch

from cse_tpu_torch.ops import _build
from cse_tpu_torch.ops import fused_stack as fs
from cse_tpu_torch.ops.fused_stack import LN_EPS, wide
from cse_tpu_torch.utils.profiling import span

W_NAMES = ("qkv_w", "qkv_b", "out_w", "out_b", "ln1_s", "ln1_b",
           "ln2_s", "ln2_b", "f1_w", "f1_b", "f2_w", "f2_b")
MAT_NAMES = ("qkv_w", "out_w", "f1_w", "f2_w")
WGRAD_BLOCKS = 528  # fp32 weight-gradient blocks to aim for: 4 per SM of an H100
WGRAD_UNITS_PER_SM = 2  # bf16: (tile, slab) units a block of the persistent grid takes
BWD_STRIP_MAX_L = 256  # csrc/fused_train.cu's STRIP_MAX_L: the bf16 attention backward's one-pass route
# what cse_layer_norm_bwd_info writes, in order, and its load paths (csrc/fused_train.cu::LnbPath)
LN_BWD_INFO_KEYS = ("path_code", "threads", "rows_per_block", "smem_bytes", "registers", "local_bytes",
                    "blocks_per_sm")
LN_BWD_PATHS = {0: "narrow", 1: "wide"}



def qv_part(qkv_b_grad: torch.Tensor) -> torch.Tensor:
    """The q and v thirds of a packed qkv-bias gradient ``[..., 3D]``.

    The key bias adds the same q.b_k to every score of a row, which the
    softmax cancels: its gradient is zero up to rounding noise, so a relative
    comparison of two implementations leaves that third out."""
    d = qkv_b_grad.shape[-1] // 3
    return torch.cat([qkv_b_grad[..., :d], qkv_b_grad[..., 2 * d :]], dim=-1)


# ---------------------------------------------------------------- plain versions


def weight_grad_plain(a, dy):
    """``a[M, K]^T @ dy[M, N]`` with the operands as given, accumulated wide."""
    return wide(a).t() @ wide(dy)


def linear_relu_grad_plain(dy, wt, mask):
    """dpre = where(mask > 0, dy @ wt, 0): (dpre in dy's dtype, its column sums)."""
    v = wide(dy) @ wide(wt)
    v = torch.where(mask > 0, v, torch.zeros((), dtype=v.dtype))
    return v.to(dy.dtype), v.sum(dim=0)


def layer_norm_backward_plain(dh, x, scale, g_in, out32=None, cd=None):
    """Backward of y = LN(x) * scale + b (eps 1e-6) for ``dh = dL/dy``, added to
    the residual gradient: g_out = g_in + dx.

    Returns (out32, out_cd, sums): ``out32`` (given tensor, written; may be
    ``g_in``) or None, g_out in ``cd`` or None, and sums ``[4, D]`` =
    (dscale, dbias, column sums of g_in, column sums of g_out)."""
    mu = x.mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(((x - mu) ** 2).mean(dim=-1, keepdim=True) + LN_EPS)
    xhat = (x - mu) * inv
    dxhat = dh * scale
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    gi = wide(g_in)
    go = gi + inv * (dxhat - m1 - xhat * m2)
    sums = torch.stack([(dh * xhat).sum(0), dh.sum(0), gi.sum(0), go.sum(0)])
    if out32 is not None:
        out32.copy_(go)
    return out32, None if cd is None else go.to(cd), sums


def attention_backward_plain(qkv, dattn, stats, seq_len, nhead, cd):
    """Backward of :func:`fused_stack.attention_plain` from its saved row stats.

    qkv ``[G*L, 3D]`` fp32, dattn ``[G*L, D]`` fp32 (gradient of the attention
    output), stats ``[2, G*L, H]`` (max, 1/z). Recomputes p = exp(s - m), then
    dv = cd(p)^T cd(do*invz), dp = cd(do) cd(v)^T, delta = rowsum(dp*p)*invz,
    ds = p*(dp - delta)*invz, dq = scale*cd(ds) cd(k), dk = cd(ds)^T cd(scale*q).
    Returns (dqkv in cd, the column sums of the wide dqkv)."""
    M, D3 = qkv.shape
    D, L, H = D3 // 3, seq_len, nhead
    G, hd = M // L, D // H
    scale = 1.0 / math.sqrt(hd)
    heads = qkv.reshape(G, L, 3, H, hd).permute(2, 0, 3, 1, 4)  # [3, G, H, L, hd]
    do_all = dattn.reshape(G, L, H, hd).permute(0, 2, 1, 3)  # [G, H, L, hd]
    st = stats.reshape(2, G, L, H).permute(0, 1, 3, 2)[..., None]  # [2, G, H, L, 1]
    dqkv = torch.empty(G, L, 3, H, hd, dtype=wide(qkv).dtype, device=qkv.device)
    c = lambda t: wide(t.to(cd))
    step = max(1, (1 << 27) // (H * L * L))
    for g0 in range(0, G, step):
        sl = slice(g0, g0 + step)
        q, k, v = heads[:, sl]
        do, m, iz = do_all[sl], st[0, sl], st[1, sl]
        qs = c(q * scale)
        p = torch.exp(qs @ c(k).transpose(-1, -2) - m)
        dv = c(p).transpose(-1, -2) @ c(do * iz)
        dp = c(do) @ c(v).transpose(-1, -2)
        delta = (dp * p).sum(dim=-1, keepdim=True) * iz
        ds = p * (dp - delta) * iz
        dq = scale * (c(ds) @ c(k))
        dk = c(ds).transpose(-1, -2) @ qs
        dqkv[sl] = torch.stack([dq, dk, dv], dim=1).permute(0, 3, 1, 2, 4)
    dqkv = dqkv.reshape(M, D3)
    return dqkv.to(cd), dqkv.sum(dim=0)


# ---------------------------------------------------------------- kernel wrappers


def _ptr(t):
    return None if t is None else t.data_ptr()


def wgrad_plan(M: int, K: int, N: int, bf16: bool, sms: int = 132) -> tuple[int, int]:
    """``(slab, slabs)``: the rows of each slab of ``cse_weight_grad`` and
    their number (``slabs * slab >= M > (slabs - 1) * slab``).

    bf16: the kernel's output tiles are 128 x 256 for N > 128, else 128 x 128;
    a work unit is (tile, slab), and the slabs are as many as make about
    :data:`WGRAD_UNITS_PER_SM` units for each of the ``sms`` blocks of the
    persistent grid, each a multiple of 64 rows (one TMA chunk). fp32: 64 x 64
    tiles, one block per (tile, slab), about :data:`WGRAD_BLOCKS` blocks."""
    if bf16:  # the tile rule of csrc/fused_train.cu::cse_weight_grad
        tiles = -(-K // 128) * -(-N // (256 if N > 128 else 128))
        slab = -(-M // -(-sms * WGRAD_UNITS_PER_SM // tiles) // 64) * 64
    else:
        tiles = -(-K // 64) * -(-N // 64)
        slab = -(-M // max(1, -(-WGRAD_BLOCKS // tiles)) // 32) * 32
    return slab, max(1, -(-M // slab))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def weight_grad(a, dy):
    """dW ``[K, N]`` fp32 = ``a[M, K]^T @ dy[M, N]``; kernel (a) of
    fused_train.cu on CUDA: slab partials, then their fixed-order sum."""
    if not fs._route(a, dy):
        return weight_grad_plain(a, dy)
    if a.dtype not in fs._KERNEL_DTYPES or dy.dtype != a.dtype:
        raise TypeError(f"weight_grad kernel takes two fp32 or two bf16 operands, got {a.dtype}, {dy.dtype}")
    fs._check(a, "a", None, 2)
    fs._check(dy, "dy", None, 2)
    (M, K), (M2, N) = a.shape, dy.shape
    if M2 != M:
        raise ValueError(f"a {tuple(a.shape)} and dy {tuple(dy.shape)} differ in rows")
    bf = a.dtype == torch.bfloat16
    if bf and (K % 8 or N % 8 or a.data_ptr() % 16 or dy.data_ptr() % 16):
        raise ValueError("bf16 weight_grad kernel needs K % 8 == N % 8 == 0 and 16-byte aligned operands")
    slab, slabs = wgrad_plan(M, K, N, bf, _sm_count(a.device.index or 0))
    partials = torch.empty(slabs, K, N, dtype=torch.float32, device=a.device)
    dw = torch.empty(K, N, dtype=torch.float32, device=a.device)
    err = _build.library().cse_weight_grad(
        a.data_ptr(), dy.data_ptr(), partials.data_ptr(), dw.data_ptr(), int(bf), M, K, N, slab,
        slabs, fs._stream())
    fs._check_launch("weight_grad", err)
    weight_grad.launches += 1
    return dw


def linear_relu_grad(dy, wt, mask):
    """See :func:`linear_relu_grad_plain`; on CUDA the serving stack's GEMM with its
    ReLU-gradient epilogue, the column sums from per-block partials."""
    if not fs._route(dy, wt, mask):
        return linear_relu_grad_plain(dy, wt, mask)
    if dy.dtype not in fs._KERNEL_DTYPES:
        raise TypeError(f"linear_relu_grad kernel takes fp32 or bf16 operands, not {dy.dtype}")
    fs._check(dy, "dy", None, 2)
    fs._check(wt, "wt", dy.dtype, 2)
    fs._check(mask, "mask", dy.dtype, 2)
    (M, K), (K2, N) = dy.shape, wt.shape
    if K2 != K or tuple(mask.shape) != (M, N):
        raise ValueError(f"shapes dy {tuple(dy.shape)}, wt {tuple(wt.shape)}, mask {tuple(mask.shape)}")
    bf = dy.dtype == torch.bfloat16
    if bf and (K % 8 or N % 8 or dy.data_ptr() % 16 or wt.data_ptr() % 16 or mask.data_ptr() % 4):
        raise ValueError("bf16 linear_relu_grad kernel needs K % 8 == N % 8 == 0 and aligned operands")
    out = torch.empty(M, N, dtype=dy.dtype, device=dy.device)
    partials = torch.empty(-(-M // (128 if bf else 64)), N, dtype=torch.float32, device=dy.device)
    colsum = torch.empty(N, dtype=torch.float32, device=dy.device)
    zero_bias = torch.zeros(N, dtype=torch.float32, device=dy.device)
    err = _build.library().cse_linear_relu_grad(
        dy.data_ptr(), wt.data_ptr(), zero_bias.data_ptr(), mask.data_ptr(), out.data_ptr(),
        partials.data_ptr(), colsum.data_ptr(), int(bf), M, N, K, fs._stream())
    fs._check_launch("linear_relu_grad", err)
    linear_relu_grad.launches += 1
    return out, colsum


class LnBwdPlan(NamedTuple):
    blocks: int  # the grid
    rows_per_warp: int  # the most rows a warp takes
    partials: tuple[int, int, int]  # the per-block column sums: [blocks, 4, D]


def ln_bwd_plan(M: int, D: int, sms: int, per_sm: int, rows_per_block: int) -> LnBwdPlan:
    """The grid of ``cse_layer_norm_bwd`` for ``M`` rows of width ``D``.

    Persistent: ``sms * per_sm`` blocks (``per_sm``: the blocks of the kernel
    that fit an SM at once, from the occupancy query), no more than give
    every block a row, at least one. A block has ``rows_per_block`` warps
    (both from ``cse_layer_norm_bwd_info``); warp w of the grid's W =
    blocks * rows_per_block takes rows w, w + W, ... (on the wide path as
    row w % R of the R-row tiles w // R, w // R + blocks, ...); each block
    writes one row of four column sums."""
    blocks = max(1, min(sms * max(per_sm, 1), -(-M // rows_per_block)))
    return LnBwdPlan(blocks, -(-M // (blocks * rows_per_block)), (blocks, 4, D))


def _ln_bwd_width(D: int) -> bool:
    """The widths ``cse_layer_norm_bwd`` takes: the wide path at D % 128 ==
    0, the narrow one (a column a lane, masked past D) at any other D % 8 ==
    0 up to 256."""
    return D % 8 == 0 and 8 <= D <= 256


@functools.cache
def _ln_bwd_launch(D: int, g_bf16: bool, out_bf16: bool, aligned: bool) -> dict:
    return _build.query("cse_layer_norm_bwd_info", LN_BWD_INFO_KEYS, D, int(g_bf16), int(out_bf16), int(aligned))


def _ln_bwd_plan_of(M: int, D: int, launch: dict, device: int) -> LnBwdPlan:
    return ln_bwd_plan(M, D, _sm_count(device), launch["blocks_per_sm"], launch["rows_per_block"])


def layer_norm_backward(dh, x, scale, g_in, out32=None, cd=None):
    """See :func:`layer_norm_backward_plain`; kernel (b) of fused_train.cu on
    CUDA (``out32`` may be ``g_in`` itself when that is fp32): a persistent
    grid (:func:`ln_bwd_plan`), then the fixed-order sum of its partials."""
    if not fs._route(dh, x, scale, g_in, out32):
        return layer_norm_backward_plain(dh, x, scale, g_in, out32, cd)
    for t, n in ((dh, "dh"), (x, "x")):
        fs._check(t, n, torch.float32, 2)
    M, D = x.shape
    if tuple(dh.shape) != (M, D) or tuple(g_in.shape) != (M, D) or not _ln_bwd_width(D):
        raise ValueError(f"layer_norm_backward takes [M, D] with D % 8 == 0, D <= 256; got {tuple(x.shape)}")
    fs._check(scale, "scale", torch.float32, 1)
    fs._check(g_in, "g_in", None, 2)
    if g_in.dtype not in fs._KERNEL_DTYPES or (cd is not None and cd not in fs._KERNEL_DTYPES):
        raise TypeError(f"layer_norm_backward kernel takes fp32 or bf16, got {g_in.dtype} / {cd}")
    if out32 is not None:
        fs._check(out32, "out32", torch.float32, 2)
    out_cd = None if cd is None else torch.empty(M, D, dtype=cd, device=x.device)
    g_bf16, o_bf16 = g_in.dtype == torch.bfloat16, cd == torch.bfloat16
    aligned = all(t is None or t.data_ptr() % 16 == 0 for t in (dh, x, g_in, out32, out_cd))
    plan = _ln_bwd_plan_of(M, D, _ln_bwd_launch(D, g_bf16, o_bf16, aligned), x.device.index or 0)
    partials = torch.empty(plan.partials, dtype=torch.float32, device=x.device)
    sums = torch.empty(4, D, dtype=torch.float32, device=x.device)
    err = _build.library().cse_layer_norm_bwd(
        dh.data_ptr(), x.data_ptr(), scale.data_ptr(), g_in.data_ptr(), _ptr(out32), _ptr(out_cd),
        partials.data_ptr(), sums.data_ptr(), int(g_bf16), int(o_bf16), M, D, LN_EPS, plan.blocks, fs._stream())
    fs._check_launch("layer_norm_backward", err)
    layer_norm_backward.launches += 1
    return out32, out_cd, sums


def layer_norm_backward_info(M: int, D: int = 256, g_dtype: torch.dtype = torch.float32,
                             cd: torch.dtype | None = torch.bfloat16, aligned: bool = True) -> dict:
    """How :func:`layer_norm_backward` launches for ``M`` rows of width ``D``,
    g_in in ``g_dtype`` and g_out in ``cd`` (the main path: fp32 in, bf16
    out), every tensor 16-byte aligned unless ``aligned`` is false: its path ("wide" for D % 128 == 0:
    tiles of rows through a ring of bulk copies, 16-byte accesses; else
    "narrow": a column a lane), threads, rows a block takes at a time,
    dynamic shared bytes, registers and local-memory bytes a thread, blocks
    per SM (the occupancy query), and the grid and the most rows a warp takes
    (:func:`ln_bwd_plan`)."""
    if not _ln_bwd_width(D):
        raise ValueError(f"layer_norm_backward takes D % 8 == 0, D <= 256; got {D}")
    info = dict(_ln_bwd_launch(D, g_dtype == torch.bfloat16, cd == torch.bfloat16, aligned))
    plan = _ln_bwd_plan_of(M, D, info, torch.cuda.current_device())
    info.update(path=LN_BWD_PATHS[info["path_code"]], grid=plan.blocks, rows_per_warp=plan.rows_per_warp)
    return info


def attention_backward(qkv, dattn, stats, seq_len, nhead, cd):
    """See :func:`attention_backward_plain`; kernels (c) of fused_train.cu on
    CUDA: bf16 at L <= 256 one block per (sequence, head) in one pass, else
    dq with delta, then dk/dv; then the column sums."""
    if not fs._route(qkv, dattn, stats):
        return attention_backward_plain(qkv, dattn, stats, seq_len, nhead, cd)
    if cd not in fs._KERNEL_DTYPES:
        raise TypeError(f"attention_backward kernel writes fp32 or bf16, not {cd}")
    fs._check(qkv, "qkv", torch.float32, 2)
    fs._check(dattn, "dattn", torch.float32, 2)
    fs._check(stats, "stats", torch.float32, 3)
    M, D3 = qkv.shape
    D = D3 // 3
    if D3 % 3 or D % nhead or M % seq_len or tuple(dattn.shape) != (M, D) or tuple(stats.shape) != (2, M, nhead):
        raise ValueError(f"qkv {tuple(qkv.shape)}, dattn {tuple(dattn.shape)}, stats {tuple(stats.shape)} "
                         f"do not fit L={seq_len}, {nhead} heads")
    hd = D // nhead
    fs.check_head_width(hd, "attention backward")
    if qkv.data_ptr() % 16 or dattn.data_ptr() % 16:
        raise ValueError("attention backward kernel needs 16-byte aligned qkv and dattn")
    G = M // seq_len
    strip = cd == torch.bfloat16 and seq_len <= BWD_STRIP_MAX_L
    dqkv = torch.empty(M, D3, dtype=cd, device=qkv.device)
    delta = None if strip else torch.empty(M, nhead, dtype=torch.float32, device=qkv.device)
    rows = G if strip else G * -(-seq_len // 64)  # one partial row per sequence, or per 64-row tile
    partials = torch.empty(rows, D3, dtype=torch.float32, device=qkv.device)
    dbias = torch.empty(D3, dtype=torch.float32, device=qkv.device)
    err = _build.library().cse_attention_bwd(
        qkv.data_ptr(), dattn.data_ptr(), stats.data_ptr(), _ptr(delta), dqkv.data_ptr(),
        partials.data_ptr(), dbias.data_ptr(), int(cd == torch.bfloat16), G, seq_len, nhead, hd,
        1.0 / math.sqrt(hd), fs._stream())
    fs._check_launch("attention_backward", err)
    attention_backward.launches += 1
    return dqkv, dbias


def attention_backward_info(seq_len: int, hd: int = 32) -> dict:
    """How :func:`attention_backward` launches the bf16 backward at this L and
    head width: see :func:`cse_tpu_torch.ops._build.launch_info` ("strip" for
    L <= 256, "passes" for the two kernels beyond, described by the dq one)."""
    fs.check_head_width(hd, "attention backward")
    return _build.launch_info("cse_attention_bwd_info", seq_len, hd)


KERNELS = {"weight_grad": weight_grad, "linear_relu_grad": linear_relu_grad,
           "layer_norm_backward": layer_norm_backward, "attention_backward": attention_backward}


def reset_launches():
    """Zero the counts of these wrappers and of :mod:`fused_stack`'s."""
    fs.reset_launches()
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    """Calls of every kernel wrapper of the training path since the reset."""
    return {**fs.launch_counts(), **{name: fn.launches for name, fn in KERNELS.items()}}


reset_launches()


def launches_per_train_stack(n_layers: int, chunk: int = 1) -> dict[str, int]:
    """Wrapper calls of one stack's forward and backward through
    :func:`fused_stack_train` (the final LN is plain torch).

    Per layer: forward and replay 2 LN + 4 GEMM + 1 attention each (the
    replay skips the last layer's FFN2 of each chunk); backward 4 dX GEMMs
    (3 bias-free + the ReLU-gradient one), 4 weight gradients, 2 LN backward,
    1 attention backward."""
    n_chunks = -(-n_layers // chunk)
    return {"layer_norm": 4 * n_layers, "linear": 8 * n_layers - n_chunks + 3 * n_layers,
            "attention": 2 * n_layers, "weight_grad": 4 * n_layers, "linear_relu_grad": n_layers,
            "layer_norm_backward": 2 * n_layers, "attention_backward": n_layers}


# ---------------------------------------------------------------- the layers

KERNEL_OPS = types.SimpleNamespace(
    ln=fs.layer_norm, lin=fs.linear, attn=fs.attention, wgrad=weight_grad,
    relu_grad=linear_relu_grad, ln_bwd=layer_norm_backward, attn_bwd=attention_backward)
PLAIN_OPS = types.SimpleNamespace(
    ln=fs.layer_norm_plain, lin=fs.linear_plain, attn=fs.attention_plain, wgrad=weight_grad_plain,
    relu_grad=linear_relu_grad_plain, ln_bwd=layer_norm_backward_plain, attn_bwd=attention_backward_plain)


def _kernel_weights(w):
    """Stacked cd weights -> the kernels' operands: matrices as given
    (contiguous), vectors in the accumulation type."""
    return {k: w[k].contiguous() if k in MAT_NAMES else wide(w[k]).contiguous() for k in W_NAMES}


def layers_forward(x, w, nhead, ops=KERNEL_OPS):
    """``_fwd_kernel``: the chunk's layers on x ``[G, L, D]``, fp32 residual
    inside, the result in x's dtype. ``w``: stacked ``[n, ...]`` weights in cd."""
    G, L, D = x.shape
    cd = w["qkv_w"].dtype
    wk = _kernel_weights(w)
    r = x.reshape(G * L, D).to(wide(x).dtype, copy=True)  # updated in place
    for li in range(w["qkv_w"].shape[0]):
        fs.run_layer(r, wk, li, L, nhead, cd, ops.ln, ops.lin, ops.attn)
    return r.to(x.dtype).reshape(G, L, D)


def layers_backward(x, gy, w, nhead, ops=KERNEL_OPS):
    """``_bwd_kernel``: replay the chunk from x, back-propagate gy.

    Returns (dx in x's dtype, {name: fp32 gradient ``[n, ...]``})."""
    G, L, D = x.shape
    M, n = G * L, w["qkv_w"].shape[0]
    cd = w["qkv_w"].dtype
    wk = _kernel_weights(w)
    acc_t = wide(torch.empty((), dtype=cd)).dtype
    zeros_d = torch.zeros(D, dtype=acc_t, device=x.device)

    # replay, keeping each layer's internals (n is 1 at chunk=1)
    r = x.reshape(M, D).to(acc_t, copy=True)
    saves = []
    for li in range(n):
        x0, r = r, r.clone()  # keep the layer input; r goes on, updated in place
        h1 = ops.ln(r, wk["ln1_s"][li], wk["ln1_b"][li], cd)
        qkv = ops.lin(h1, wk["qkv_w"][li], wk["qkv_b"][li], "bias")
        stats = torch.empty(2, M, nhead, dtype=acc_t, device=x.device)
        a = ops.attn(qkv, L, nhead, cd, stats)
        ops.lin(a, wk["out_w"][li], wk["out_b"][li], "residual", r)
        x1 = r.clone() if li < n - 1 else r  # the chunk's last layer skips FFN2
        h2 = ops.ln(r, wk["ln2_s"][li], wk["ln2_b"][li], cd)
        hrelu = ops.lin(h2, wk["f1_w"][li], wk["f1_b"][li], "relu")
        if li < n - 1:
            ops.lin(hrelu, wk["f2_w"][li], wk["f2_b"][li], "residual", r)
        saves.append((x0, h1, qkv, stats, a, x1, h2, hrelu))
    del r

    grads = {k: [None] * n for k in W_NAMES}
    g = gy.reshape(M, D).contiguous()  # the residual gradient: gy, then fp32
    g_cd = g if g.dtype == cd else g.to(cd)
    wide_cd = cd == acc_t  # fp32 (or float64) compute: the cd copy is the wide tensor
    for li in reversed(range(n)):
        x0, h1, qkv, stats, a, x1, h2, hrelu = saves[li]
        # FFN: x2 = x1 + relu(LN2(x1) W1 + b1) W2 + b2
        grads["f2_w"][li] = ops.wgrad(hrelu, g_cd)
        dpre, grads["f1_b"][li] = ops.relu_grad(g_cd, wk["f2_w"][li].t().contiguous(), hrelu)
        grads["f1_w"][li] = ops.wgrad(h2, dpre)
        dh2 = ops.lin(dpre, wk["f1_w"][li].t().contiguous(), zeros_d, "bias")
        g1 = torch.empty(M, D, dtype=acc_t, device=x.device)
        g1, g1_cd, sums = ops.ln_bwd(dh2, x1, wk["ln2_s"][li], g, g1, None if wide_cd else cd)
        g1_cd = g1 if wide_cd else g1_cd
        grads["ln2_s"][li], grads["ln2_b"][li], grads["f2_b"][li], grads["out_b"][li] = sums
        # attention: x1 = x0 + MHSA(LN1(x0)) Wo + bo
        grads["out_w"][li] = ops.wgrad(a, g1_cd)
        dattn = ops.lin(g1_cd, wk["out_w"][li].t().contiguous(), zeros_d, "bias")
        dqkv, grads["qkv_b"][li] = ops.attn_bwd(qkv, dattn, stats, L, nhead, cd)
        grads["qkv_w"][li] = ops.wgrad(h1, dqkv)
        dh1 = ops.lin(dqkv, wk["qkv_w"][li].t().contiguous(), zeros_d, "bias")
        keep32 = li > 0 or wide_cd or x.dtype != cd
        g, g_cd, sums = ops.ln_bwd(dh1, x0, wk["ln1_s"][li], g1, g1 if keep32 else None,
                                   None if wide_cd else cd)
        g_cd = g if wide_cd else g_cd
        grads["ln1_s"][li], grads["ln1_b"][li] = sums[0], sums[1]
        del saves[li]
    dx = g_cd if x.dtype == cd else g.to(x.dtype)
    return dx.reshape(G, L, D), {k: torch.stack(v) for k, v in grads.items()}


class FusedLayers(torch.autograd.Function):
    """``fused_layers`` of the JAX package as an autograd Function.

    ``apply(x, nhead, ops, *weights)`` with x ``[G, L, D]`` (all L positions
    real) and the 12 stacked weights in :data:`W_NAMES` order
    (``[n, din, dout]`` matrices and ``[n, dim]`` vectors, all in cd). ``ops``
    None takes the kernels for CUDA tensors and the plain versions for CPU
    ones; :data:`PLAIN_OPS` forces the plain versions (the oracle on the
    card). The forward saves only the chunk input; the backward replays the
    chunk and returns dx and each weight's gradient rounded to its dtype."""

    @staticmethod
    def forward(ctx, x, nhead, ops, *weights):
        ctx.nhead = nhead
        ctx.ops = ops or (KERNEL_OPS if x.device.type == "cuda" else PLAIN_OPS)
        ctx.save_for_backward(x, *weights)
        return layers_forward(x, dict(zip(W_NAMES, weights)), nhead, ctx.ops)

    @staticmethod
    def backward(ctx, gy):
        x, *weights = ctx.saved_tensors
        with span("train.stack_backward", {"G": x.shape[0], "L": x.shape[1]}):
            w = dict(zip(W_NAMES, weights))
            dx, dw = layers_backward(x, gy.to(x.dtype).contiguous(), w, ctx.nhead, ctx.ops)
            return (dx, None, None, *[dw[k].to(w[k].dtype) for k in W_NAMES])


def fused_layers(x, weights: dict, nhead: int, ops=None):
    """Differentiable chunk of layers (see :class:`FusedLayers`)."""
    return FusedLayers.apply(x, nhead, ops, *[weights[k] for k in W_NAMES])


def stack_train_weights(stack, compute_dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """A TransformerStack's per-layer parameters stacked inside autograd
    (gradients reach the ``nn.Parameter``\\ s): matrices ``[n, din, dout]``,
    vectors ``[n, dim]``, all rounded to cd."""
    layers = list(stack.layers)

    def stk(get, mat=False):
        t = torch.stack([get(lyr) for lyr in layers])
        return (t.transpose(1, 2) if mat else t).to(compute_dtype)

    return {
        "qkv_w": stk(lambda l: l.self_att.in_proj.weight, True),
        "qkv_b": stk(lambda l: l.self_att.in_proj.bias),
        "out_w": stk(lambda l: l.self_att.out_proj.weight, True),
        "out_b": stk(lambda l: l.self_att.out_proj.bias),
        "ln1_s": stk(lambda l: l.norm1.weight),
        "ln1_b": stk(lambda l: l.norm1.bias),
        "ln2_s": stk(lambda l: l.norm2.weight),
        "ln2_b": stk(lambda l: l.norm2.bias),
        "f1_w": stk(lambda l: l.ffn_1.weight, True),
        "f1_b": stk(lambda l: l.ffn_1.bias),
        "f2_w": stk(lambda l: l.ffn_2.weight, True),
        "f2_b": stk(lambda l: l.ffn_2.bias),
    }


def fused_stack_train(x: torch.Tensor, stack, nhead: int = 8, chunk: int = 1,
                      compute_dtype: torch.dtype = torch.bfloat16, ops=None) -> torch.Tensor:
    """Differentiable TransformerStack forward through :class:`FusedLayers`.

    x: ``[G, L, D]`` with the positional encoding added; ``stack`` a
    :class:`cse_tpu_torch.models.sepformer.TransformerStack`. The layers run
    in chunks of ``chunk`` (input rounded to cd), then the stack's final LN
    in fp32 with its unrounded parameters. Returns fp32 ``[G, L, D]``.
    ``ops``: see :class:`FusedLayers`."""
    w = stack_train_weights(stack, compute_dtype)
    n = w["qkv_w"].shape[0]
    y = x.to(compute_dtype)
    for c0 in range(0, n, chunk):
        y = fused_layers(y, {k: v[c0 : c0 + chunk] for k, v in w.items()}, nhead, ops)
    y = y.float()
    mu = y.mean(dim=-1, keepdim=True)
    var = ((y - mu) ** 2).mean(dim=-1, keepdim=True)
    return (y - mu) * torch.rsqrt(var + LN_EPS) * stack.norm.weight.float() + stack.norm.bias.float()
