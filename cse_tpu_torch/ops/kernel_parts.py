"""The kernel-parts dev tool's stripped fused forward, in its eight modes.

Port of ``scripts/bench_kernel_parts.py::make_kernel``: a pre-LN transformer
forward cut down to what costs time (LayerNorm without scale and bias, eps
1e-6; bias-free qkv / FFN1 / FFN2 products with cd operands and fp32
accumulation; softmax without a key mask; no out-projection; no final LN),
in modes that move the row mean, mean-square and softmax sum from cross-lane
reductions onto matrix products with a ones matrix ``jmat [D, 128]``:

============== ===================== ==========================================
mode           LayerNorm moments     softmax
============== ===================== ==========================================
full           centred two-pass      max, exp, sum, ``p / sum``
matmul_only    no LN (cast to cd)    skipped: ``p = s * 1e-4``
no_softmax     centred two-pass      skipped
ln_matmul      ``cd(x) @ J``         as ``full``
softmax_matmul centred two-pass      ``z = cd(p) @ J``, ``p / z``
combined       ``cd(x) @ J``         ``z = cd(p) @ J``, ``p / z``
combined_hp    fp32-exact ``x @ J``  ``z = p @ ones`` in fp32, ``p / z``
combined_x2    cd hi + lo pair @ J   hi + lo pair @ J, ``p * (1 / z)``
============== ===================== ==========================================

Two properties of the tool that the port reproduces and does not mend:
``jmat`` is ``1 / D``, so the three modes that take the softmax sum as
``p @ jmat`` divide by ``sum(p) / D`` and return D times the softmax (their
output differs from ``full``; ``combined_hp`` uses a true ones matrix and
agrees with it); and those modes contract ``p [Lp, Lp]`` with ``jmat [D, .]``,
so they need ``Lp == D``.

On the card one layer is six launches on the fp32 residual in device memory:
:func:`kp_layer_norm` (the bf16 J modes on staged rows), ``linear`` (qkv),
:func:`kp_attention` (adds the head outputs into the residual),
:func:`kp_layer_norm`, ``linear`` (FFN1, relu), ``linear`` (FFN2,
residual). The products are
:func:`cse_tpu_torch.ops.fused_stack.linear`, the port's GEMM kernel, with a
zero bias; the LayerNorm and attention kernels are ``csrc/kernel_parts.cu``.
Each wrapper launches its kernel for CUDA tensors, takes the plain version
for CPU tensors and raises otherwise; it counts its launches.

Numerics: cd is the dtype of the weights (bf16, or fp32 for the parity twin).
The tool's score product ``q @ k^T`` has fp32 operands; run in interpret mode
it is fp32-exact, and so are the plain version and the fp32 kernels. The bf16
kernels round ``q * scale`` and ``k`` to bf16 for ``mma.sync`` (as the
serving attention does), which moves a score by about 2^-9 of its size; the
plain version does the same when ``qk_dtype`` is given, so that the card can
hold the bf16 kernels against it at the bf16 bar (relative L2 <= 1e-2).
"""

from __future__ import annotations

import math

import torch

from cse_tpu_torch.ops import _build
from cse_tpu_torch.ops import fused_stack as fs

LN_EPS = 1e-6
LN_MODES = {"none": 0, "centred": 1, "cd": 2, "exact": 3, "x2": 4}
SOFTMAX_MODES = {"skip": 0, "sum": 1, "cd": 2, "ones": 1, "x2": 4}  # 'ones' is a plain fp32 sum
# mode -> (LayerNorm moments, softmax)
MODES = {
    "full": ("centred", "sum"),
    "matmul_only": ("none", "skip"),
    "no_softmax": ("centred", "skip"),
    "ln_matmul": ("cd", "sum"),
    "softmax_matmul": ("centred", "cd"),
    "combined": ("cd", "cd"),
    "combined_hp": ("exact", "ones"),
    "combined_x2": ("x2", "x2"),
}
# the modes whose softmax sum goes through jmat: D x softmax, and Lp == D
JMAT_SOFTMAX = ("cd", "x2")
KPLN_MAXD = 1024  # csrc/kernel_parts.cu's KPLN_MAXD: the widest row of the staged LayerNorm
# head widths kp_attention is instantiated for (csrc/common.cuh's KpHeadWidths): the tool runs at its own
# widths only, so it takes no head width 4 (ROADMAP.md, width limits)
HEAD_WIDTHS = (8, 16, 32, 64)
# what cse_kp_layer_norm_info writes, in order
KP_LN_INFO_KEYS = ("staged", "threads", "rows_per_block", "smem_bytes", "registers", "local_bytes", "blocks_per_sm")


def _check_mode(table, mode, what):
    if mode not in table:
        raise ValueError(f"unknown {what} {mode!r} (one of {sorted(table)})")


# ---------------------------------------------------------------- plain versions


def _jsum(v, jmat, cd, pair=False):
    """``(cd(v) @ jmat)[..., :1]`` in fp32; with ``pair`` the hi + lo split."""
    jf = jmat.float()
    hi = v.to(cd)
    s = hi.float() @ jf
    if pair:
        s = s + (v - hi.float()).to(cd).float() @ jf
    return s[..., :1]


def kp_layer_norm_plain(x, jmat, ln_mode, cd):
    """LayerNorm without scale and bias of fp32 ``x [M, D]``, written in cd."""
    _check_mode(LN_MODES, ln_mode, "LayerNorm mode")
    if ln_mode == "none":
        return x.to(cd)
    if ln_mode == "centred":
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    else:
        dt = torch.float32 if ln_mode == "exact" else cd
        mu = _jsum(x, jmat, dt, ln_mode == "x2")
        var = _jsum(x * x, jmat, dt, ln_mode == "x2") - mu * mu
    return ((x - mu) * torch.rsqrt(var + LN_EPS)).to(cd)


def kp_attention_plain(qkv, jmat, x, seq_len, nhead, sm_mode, cd, qk_dtype=None):
    """``x [G*L, D] += concat_h(cd(softmax_mode(q_h * scale @ k_h^T)) @ cd(v_h))``
    in place, for fp32 ``qkv [G*L, 3D]``. ``qk_dtype``: round ``q * scale`` and
    ``k`` to it before the score product (None: fp32 operands)."""
    _check_mode(SOFTMAX_MODES, sm_mode, "softmax mode")
    M, D3 = qkv.shape
    D, L, H = D3 // 3, seq_len, nhead
    G, hd = M // L, D // H
    scale = 1.0 / math.sqrt(hd)
    heads = qkv.reshape(G, L, 3, H, hd).permute(2, 0, 3, 1, 4)  # [3, G, H, L, hd]
    xv = x.view(G, L, H, hd)
    step = max(1, (1 << 28) // (H * L * L))
    for g0 in range(0, G, step):
        q, k, v = heads[:, g0 : g0 + step]
        q = q * scale
        if qk_dtype is not None:
            q, k = q.to(qk_dtype).float(), k.to(qk_dtype).float()
        s = q @ k.transpose(-1, -2)
        if sm_mode == "skip":
            p = s * 1e-4
        else:
            p = torch.exp(s - s.amax(dim=-1, keepdim=True))
            if sm_mode in ("sum", "ones"):
                p = p / p.sum(dim=-1, keepdim=True)
            elif sm_mode == "cd":
                p = p / _jsum(p, jmat, cd)
            else:
                p = p * (1.0 / _jsum(p, jmat, cd, pair=True))
        o = p.to(cd).float() @ v.to(cd).float()
        xv[g0 : g0 + step] += o.transpose(1, 2)
    return x


# ---------------------------------------------------------------- kernel wrappers


def _check_jmat(jmat, cd, rows):
    fs._check(jmat, "jmat", cd, 2)
    if jmat.shape[0] < rows or jmat.shape[1] < 8:
        raise ValueError(f"jmat is {tuple(jmat.shape)}, want at least [{rows}, 8]")


def kp_layer_norm(x, jmat, ln_mode, cd):
    """See :func:`kp_layer_norm_plain`; on CUDA ``kp_ln_staged_kernel`` for the
    bf16 J modes ('cd', 'exact', 'x2': x staged once through shared memory;
    D % 16 == 0, D <= :data:`KPLN_MAXD`, a 16-byte aligned x),
    ``kp_ln_rows_kernel`` for the rest (:func:`kp_layer_norm_info` names the
    route)."""
    _check_mode(LN_MODES, ln_mode, "LayerNorm mode")
    if not fs._route(x, jmat):
        return kp_layer_norm_plain(x, jmat, ln_mode, cd)
    if cd not in fs._KERNEL_DTYPES:
        raise TypeError(f"kp_layer_norm kernel writes fp32 or bf16, not {cd}")
    fs._check(x, "x", torch.float32, 2)
    M, D = x.shape
    _check_jmat(jmat, cd, D)
    if cd == torch.bfloat16 and ln_mode in ("cd", "exact", "x2") and (D % 16 or D > KPLN_MAXD or x.data_ptr() % 16):
        raise ValueError(f"the bf16 {ln_mode!r} LayerNorm kernel needs D % 16 == 0, D <= {KPLN_MAXD} and a "
                         f"16-byte aligned x, got D={D}")
    out = torch.empty(M, D, dtype=cd, device=x.device)
    err = _build.library().cse_kp_layer_norm(
        x.data_ptr(), jmat.data_ptr(), jmat.stride(0), out.data_ptr(), int(cd == torch.bfloat16),
        LN_MODES[ln_mode], M, D, LN_EPS, fs._stream())
    fs._check_launch("kp_layer_norm", err)
    kp_layer_norm.launches += 1
    return out


def kp_layer_norm_info(M: int, D: int, ln_mode: str, cd: torch.dtype = torch.bfloat16) -> dict:
    """How :func:`kp_layer_norm` launches for ``M`` rows of width ``D`` (a
    16-byte aligned x) in ``ln_mode``: ``route`` "staged" (the bf16 J modes:
    tiles of rows through a ring in shared memory, a persistent grid) or
    "rows" (a warp a row), threads, rows a block takes at a time, dynamic
    shared bytes, registers and local-memory bytes a thread, blocks per SM,
    and the grid for M rows."""
    _check_mode(LN_MODES, ln_mode, "LayerNorm mode")
    info = _build.query("cse_kp_layer_norm_info", KP_LN_INFO_KEYS, LN_MODES[ln_mode], D, int(cd == torch.bfloat16))
    info["route"] = "staged" if info["staged"] else "rows"
    tiles = -(-M // info["rows_per_block"])
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    info["grid"] = min(tiles, sms * info["blocks_per_sm"]) if info["staged"] else tiles
    return info


def kp_attention(qkv, jmat, x, seq_len, nhead, sm_mode, cd):
    """See :func:`kp_attention_plain` (the bf16 kernel rounds the score
    operands to bf16: ``qk_dtype=torch.bfloat16``); ``kp_attention_*_kernel``
    on CUDA (bf16: one pass for L <= 256, multi-pass beyond)."""
    _check_mode(SOFTMAX_MODES, sm_mode, "softmax mode")
    if not fs._route(qkv, jmat, x):
        return kp_attention_plain(qkv, jmat, x, seq_len, nhead, sm_mode, cd)
    if cd not in fs._KERNEL_DTYPES:
        raise TypeError(f"kp_attention kernel takes fp32 or bf16 operands, not {cd}")
    fs._check(qkv, "qkv", torch.float32, 2)
    fs._check(x, "x", torch.float32, 2)
    M, D3 = qkv.shape
    D = D3 // 3
    if D3 % 3 or D % nhead or M % seq_len or tuple(x.shape) != (M, D):
        raise ValueError(f"qkv {tuple(qkv.shape)}, x {tuple(x.shape)} do not split into L={seq_len}, {nhead} heads")
    hd = D // nhead
    fs.check_head_width(hd, "kp_attention", HEAD_WIDTHS)
    if qkv.data_ptr() % 16 or x.data_ptr() % 8:
        raise ValueError("kp_attention kernel needs a 16-byte aligned qkv and an 8-byte aligned x")
    _check_jmat(jmat, cd, seq_len if sm_mode in JMAT_SOFTMAX else 0)
    err = _build.library().cse_kp_attention(
        qkv.data_ptr(), jmat.data_ptr(), jmat.stride(0), x.data_ptr(), int(cd == torch.bfloat16),
        SOFTMAX_MODES[sm_mode], M // seq_len, seq_len, nhead, hd, 1.0 / math.sqrt(hd), fs._stream())
    fs._check_launch("kp_attention", err)
    kp_attention.launches += 1
    return x


def kp_attention_info(seq_len: int, sm_mode: str, hd: int = 32) -> dict:
    """How :func:`kp_attention` launches the bf16 attention at this L, mode
    and head width: see :func:`cse_tpu_torch.ops._build.launch_info`."""
    _check_mode(SOFTMAX_MODES, sm_mode, "softmax mode")
    fs.check_head_width(hd, "kp_attention", HEAD_WIDTHS)
    return _build.launch_info("cse_kp_attention_info", SOFTMAX_MODES[sm_mode], seq_len, hd)


KERNELS = {"kp_layer_norm": kp_layer_norm, "kp_attention": kp_attention}


def reset_launches():
    """Zero this module's counts and the GEMM's (``fused_stack``'s)."""
    for fn in KERNELS.values():
        fn.launches = 0
    fs.reset_launches()


def launch_counts() -> dict[str, int]:
    return {**{name: fn.launches for name, fn in KERNELS.items()}, "linear": fs.linear.launches}


reset_launches()


def launches_per_call(n_layers: int) -> dict[str, int]:
    """Launches of one :func:`kernel_parts_apply`: per layer 2 LN, 3 GEMM, 1 attention."""
    return {"kp_layer_norm": 2 * n_layers, "kp_attention": n_layers, "linear": 3 * n_layers}


# ---------------------------------------------------------------- the stripped forward


def _run(x, w, f1, f2, jmat, mode, nhead, ln, lin, attn):
    _check_mode(MODES, mode, "mode")
    ln_mode, sm_mode = MODES[mode]
    cd = w.dtype
    G, Lp, D = x.shape
    if sm_mode in JMAT_SOFTMAX and Lp != jmat.shape[0]:
        raise ValueError(f"mode {mode!r} contracts p [Lp, Lp] with jmat [{jmat.shape[0]}, .]: needs Lp == "
                         f"{jmat.shape[0]}, got {Lp}")
    if any(t.dtype != cd for t in (f1, f2, jmat)):
        raise TypeError(f"w, f1, f2 and jmat share the compute dtype; got {[t.dtype for t in (w, f1, f2, jmat)]}")
    r = x.to(torch.float32, copy=True).reshape(G * Lp, D).contiguous()
    zeros = {n: torch.zeros(n, dtype=torch.float32, device=x.device) for n in (3 * D, f1.shape[-1], D)}
    for li in range(w.shape[0]):
        h = ln(r, jmat, ln_mode, cd)
        qkv = lin(h, w[li], zeros[3 * D], "bias")
        attn(qkv, jmat, r, Lp, nhead, sm_mode, cd)
        h = ln(r, jmat, ln_mode, cd)
        f = lin(h, f1[li], zeros[f1.shape[-1]], "relu")
        lin(f, f2[li], zeros[D], "residual", r)
    return r.reshape(G, Lp, D)


def kernel_parts_plain(x, w, f1, f2, jmat, mode: str, nhead: int, qk_dtype=None) -> torch.Tensor:
    """The tool's forward step by step in PyTorch on any device: fp32
    matmuls of cd-rounded operands (set ``torch.backends.cuda.matmul.allow_tf32
    = False`` on the card). ``qk_dtype``: see :func:`kp_attention_plain`."""
    def attn(qkv, jmat, r, L, H, sm_mode, cd):
        return kp_attention_plain(qkv, jmat, r, L, H, sm_mode, cd, qk_dtype)

    return _run(x, w, f1, f2, jmat, mode, nhead, kp_layer_norm_plain, fs.linear_plain, attn)


def kernel_parts_apply(x, w, f1, f2, jmat, mode: str, nhead: int = 8) -> torch.Tensor:
    """Run the tool's ``n_layers``-layer forward in ``mode``.

    x: [G, Lp, D] fp32; w: [n, D, 3D], f1: [n, D, F], f2: [n, F, D] and jmat:
    [D, 128] in the compute dtype (bf16, or fp32 for the parity twin).
    CUDA tensors go through the kernels (:func:`launches_per_call`), CPU
    tensors through the plain versions. Returns [G, Lp, D] fp32.
    """
    fs._route(x, w, f1, f2, jmat)
    return _run(x, w, f1, f2, jmat, mode, nhead, kp_layer_norm, fs.linear, kp_attention)
