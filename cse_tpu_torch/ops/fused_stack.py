"""Inference forward of a whole TransformerStack through hand-written kernels.

Port of ``cse_tpu/ops/fused_stack.py``. The TPU kernel (``_stack_kernel``)
runs all layers of a stack in one Pallas program with the weights resident
in VMEM; on Hopper the same arithmetic runs as three CUDA kernels
(``csrc/fused_stack.cu``: row LayerNorm, tiled GEMM with three epilogues,
two-pass attention), 57 launches per stack call at 8 layers, with the fp32
residual stream kept in device memory between them. The training path
(:mod:`cse_tpu_torch.ops.fused_train`) runs its forward on the same kernels.
With ``quant="w8a8"`` the stack runs ``_stack_kernel_w8a8`` instead
(:mod:`cse_tpu_torch.ops.fused_stack_w8a8`: at the model's widths
LayerNorms that write int8, int8 projections, one int8 FFN kernel, this
module's attention with an fp32 output and its final LayerNorm; at other
widths the LayerNorms, quantizers and int8 products as separate launches).

Each kernel has a wrapper here (:func:`layer_norm`, :func:`linear`,
:func:`attention`) and a plain PyTorch version beside it (``*_plain``). A
wrapper launches its kernel for a CUDA tensor, takes the plain version for a
CPU tensor, and raises for anything else. Each wrapper counts its launches
in its ``launches`` attribute (:func:`launch_counts`, :func:`reset_launches`).

Numerics contract (that of the TPU kernel): the input is rounded to
``compute_dtype`` (cd), then carried in fp32; every stacked tensor is rounded
to cd (projection weights and also biases and LN scales); matmul operands
are cd with fp32 accumulation; LN (eps 1e-6) and softmax are fp32; q is
scaled by 1/sqrt(hd) and rounded to cd; the softmax normalisation is applied
after PV; the output takes the dtype of the input as given. The plain
versions accumulate in fp32, or in float64 for float64 operands (the CPU
gradient checks of the training path).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from cse_tpu_torch.ops import _build

QUANT_MODES = (None, "w8a8")
LN_EPS = 1e-6
EPILOGUES = {"bias": 0, "relu": 1, "residual": 2}
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def check_quant_mode(quant):
    if quant not in QUANT_MODES:
        raise ValueError(f"unknown quant mode {quant!r} (None or 'w8a8')")


def int8_scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-12) / 127 as a true fp32 division on every device: on
    CUDA, PyTorch divides by a Python scalar as a multiply by its reciprocal,
    which rounds differently in some ulps, so the divisor is a tensor."""
    amax = amax.clamp_min(1e-12)
    return amax / torch.full_like(amax, 127.0)


def quantize_stacked(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of a stacked fp32 ``[n, din, dout]``
    weight (``_quantize_stacked``, :159): scale = max(max |w| over din,
    1e-12) / 127, payload = round-half-even(w / scale). Returns (int8
    ``[n, din, dout]``, fp32 scale ``[n, 1, dout]``)."""
    wf = w.float()
    s = int8_scale(wf.abs().amax(dim=1, keepdim=True))
    return torch.round(wf / s).to(torch.int8), s


def k_major(w8: torch.Tensor) -> torch.Tensor:
    """``w8 [..., K, N]`` (the same values) stored K-major: each output
    channel's K values contiguous, a transposed view of a contiguous
    ``[..., N, K]`` tensor. The int8 GEMM reads its weight so, with no copy
    (:func:`cse_tpu_torch.ops.fused_stack_w8a8.linear_w8a8`)."""
    return w8.transpose(-1, -2).contiguous().transpose(-1, -2)


def stack_weights(stack, compute_dtype: torch.dtype, quant: str | None = None) -> dict[str, torch.Tensor]:
    """Stack a :class:`cse_tpu_torch.models.sepformer.TransformerStack`'s
    per-layer parameters for :func:`fused_stack_apply`.

    Projection weights become ``[n_layers, din, dout]`` in cd (the GEMM's B
    operand, row-major); with ``quant="w8a8"`` int8 payloads of the fp32
    weights (never a cd-rounded copy), stored K-major (:func:`k_major`: made
    once here, read by the int8 GEMM as they are), with their fp32
    ``[n_layers, 1, dout]`` scales under ``*_s`` (:func:`quantize_stacked`).
    Biases and LN
    scales/offsets are rounded to cd like the TPU kernel's inputs and then
    held in fp32, the type the kernels add them in.
    """
    check_quant_mode(quant)
    cd = compute_dtype
    layers = list(stack.layers)

    def stk(get, mat=False):
        t = torch.stack([get(lyr).detach() for lyr in layers])
        t = t.transpose(1, 2).to(cd) if mat else t.to(cd).float()
        return t.contiguous()

    mats = {}
    if quant == "w8a8":
        for name, get in (("qkv", lambda l: l.self_att.in_proj.weight), ("out", lambda l: l.self_att.out_proj.weight),
                          ("f1", lambda l: l.ffn_1.weight), ("f2", lambda l: l.ffn_2.weight)):
            q, sc = quantize_stacked(torch.stack([get(lyr).detach() for lyr in layers]).transpose(1, 2))
            mats[f"{name}_w"], mats[f"{name}_s"] = k_major(q), sc.contiguous()
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
        "fn_s": stack.norm.weight.detach().to(cd).float().contiguous(),
        "fn_b": stack.norm.bias.detach().to(cd).float().contiguous(),
        **mats,
    }


# ---------------------------------------------------------------- plain versions


def wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the plain versions' accumulation type: fp32, or float64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def layer_norm_plain(x, scale, bias, out_dtype):
    """LN over the last axis of fp32 ``x`` (eps 1e-6), written in out_dtype."""
    m = x.mean(dim=-1, keepdim=True)
    v = ((x - m) ** 2).mean(dim=-1, keepdim=True)
    return ((x - m) * torch.rsqrt(v + LN_EPS) * scale + bias).to(out_dtype)


def linear_plain(a, w, bias, epilogue, residual=None):
    """``a[M, K] @ w[K, N] + bias`` with operands as given (cd) multiplied in
    fp32. epilogue 'bias' -> fp32; 'relu' -> a's dtype; 'residual' -> added
    into the fp32 ``residual`` in place (returned)."""
    y = wide(a) @ wide(w) + bias
    if epilogue == "bias":
        return y
    if epilogue == "relu":
        return torch.relu(y).to(a.dtype)
    if epilogue == "residual":
        return residual.add_(y)
    raise ValueError(f"unknown epilogue {epilogue!r}")


def attention_plain(qkv, seq_len, nhead, out_dtype, stats=None, operand_dtype=None):
    """Masked MHSA of the TPU kernel: qkv ``[G*L, 3D]`` fp32 -> ``[G*L, D]``.

    q*scale, k, v rounded to cd (``operand_dtype``, by default out_dtype);
    scores, max, exp and the sum in fp32; cd(p) @ cd(v) in fp32, divided by
    z after PV, written in out_dtype. Sequences are processed in groups so
    the fp32 score tensor stays near 1 GB. ``stats`` (``[2, G*L, H]``), when
    given, receives each row's max and 1/z.
    """
    M, D3 = qkv.shape
    D, L, H = D3 // 3, seq_len, nhead
    G, hd = M // L, D // H
    cd = operand_dtype or out_dtype
    scale = 1.0 / math.sqrt(hd)
    heads = qkv.reshape(G, L, 3, H, hd).permute(2, 0, 3, 1, 4)  # [3, G, H, L, hd]
    out = torch.empty(G, L, H, hd, dtype=out_dtype, device=qkv.device)
    step = max(1, (1 << 28) // (H * L * L))
    for g0 in range(0, G, step):
        q, k, v = heads[:, g0 : g0 + step]
        s = wide((q * scale).to(cd)) @ wide(k.to(cd)).transpose(-1, -2)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        z = p.sum(dim=-1, keepdim=True)
        o = (wide(p.to(cd)) @ wide(v.to(cd))) / z
        out[g0 : g0 + step] = o.transpose(1, 2).to(out_dtype)
        if stats is not None:  # [n, H, L, 1] -> rows (g, l) x heads
            rows = slice(g0 * L, (g0 + q.shape[0]) * L)
            stats[0, rows] = m[..., 0].transpose(1, 2).reshape(-1, H)
            stats[1, rows] = (1.0 / z[..., 0]).transpose(1, 2).reshape(-1, H)
    return out.reshape(M, D)


# ---------------------------------------------------------------- kernel wrappers


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _check_launch(name: str, err: int):
    if err != 0:
        raise RuntimeError(f"cse_tpu_torch: {name} kernel launch failed (cudaError {err})")


def _route(*tensors) -> bool:
    """True -> launch the kernel (all CUDA); False -> plain version (all CPU)."""
    devs = {t.device.type for t in tensors if t is not None}
    if devs == {"cuda"}:
        return True
    if devs == {"cpu"}:
        return False
    raise RuntimeError(f"cse_tpu_torch kernels take CUDA or CPU tensors, got {devs}")


def _check(t, name, dtype=None, ndim=None):
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if ndim is not None and t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")


def layer_norm(x, scale, bias, out_dtype):
    """Row LayerNorm of fp32 ``x [M, D]``; kernel (a) on CUDA."""
    if not _route(x, scale, bias):
        return layer_norm_plain(x, scale, bias, out_dtype)
    if out_dtype not in _KERNEL_DTYPES:
        raise TypeError(f"layer_norm kernel writes fp32 or bf16, not {out_dtype}")
    _check(x, "x", torch.float32, 2)
    M, D = x.shape
    for t, n in ((scale, "scale"), (bias, "bias")):
        _check(t, n, torch.float32, 1)
        if t.numel() != D:
            raise ValueError(f"{n} has {t.numel()} entries, x has {D} columns")
    out = torch.empty(M, D, dtype=out_dtype, device=x.device)
    err = _build.library().cse_layer_norm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.bfloat16), M, D, LN_EPS, _stream())
    _check_launch("layer_norm", err)
    layer_norm.launches += 1
    return out


def linear(a, w, bias, epilogue, residual=None):
    """``epilogue(a @ w + bias)``, see :func:`linear_plain`; kernel (b) on CUDA."""
    if not _route(a, w, bias, residual):
        return linear_plain(a, w, bias, epilogue, residual)
    if a.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"linear kernel takes fp32 or bf16 operands, not {a.dtype}")
    _check(a, "a", None, 2)
    _check(w, "w", a.dtype, 2)
    _check(bias, "bias", torch.float32, 1)
    (M, K), (K2, N) = a.shape, w.shape
    if K2 != K or bias.numel() != N:
        raise ValueError(f"shapes a {tuple(a.shape)}, w {tuple(w.shape)}, bias {tuple(bias.shape)}")
    bf = a.dtype == torch.bfloat16
    if bf and (K % 8 or N % 8 or a.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("bf16 linear kernel needs K % 8 == N % 8 == 0 and 16-byte aligned operands")
    if epilogue == "bias":
        out = torch.empty(M, N, dtype=torch.float32, device=a.device)
    elif epilogue == "relu":
        out = torch.empty(M, N, dtype=a.dtype, device=a.device)
    elif epilogue == "residual":
        _check(residual, "residual", torch.float32, 2)
        if tuple(residual.shape) != (M, N):
            raise ValueError(f"residual is {tuple(residual.shape)}, want {(M, N)}")
        out = residual
    else:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    err = _build.library().cse_linear(
        a.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), int(bf),
        EPILOGUES[epilogue], M, N, K, _stream())
    _check_launch("linear", err)
    linear.launches += 1
    return out


# head widths the attention kernels are instantiated for (csrc/common.cuh's
# HeadWidths): the JAX suite's 4, the tiny model's 8 and the paper's 32 among
# them (the Pallas kernels take any width; ROADMAP.md records the rest)
HEAD_WIDTHS = (4, 8, 16, 32, 64)


def check_head_width(hd: int, what: str, widths=HEAD_WIDTHS):
    if hd not in widths:
        raise ValueError(f"{what} kernels take head widths {', '.join(map(str, widths))}; got {hd}")


ATT_MODES = {(torch.float32, torch.float32): 0, (torch.bfloat16, torch.bfloat16): 1,
             (torch.bfloat16, torch.float32): 2}  # (operands, output) -> cse_attention mode


def attention(qkv, seq_len, nhead, out_dtype, stats=None, operand_dtype=None):
    """Masked MHSA over sequences of ``seq_len``; kernel (c) on CUDA.
    ``stats``, ``operand_dtype``: see :func:`attention_plain`."""
    if not _route(qkv, stats):
        return attention_plain(qkv, seq_len, nhead, out_dtype, stats, operand_dtype)
    mode = ATT_MODES.get((operand_dtype or out_dtype, out_dtype))
    if mode is None:
        raise TypeError(f"attention kernel takes fp32 or bf16 operands and writes fp32 or their type, "
                        f"not {operand_dtype} -> {out_dtype}")
    _check(qkv, "qkv", torch.float32, 2)
    M, D3 = qkv.shape
    D = D3 // 3
    if D3 % 3 or D % nhead or M % seq_len:
        raise ValueError(f"qkv {tuple(qkv.shape)} does not split into L={seq_len}, {nhead} heads")
    hd = D // nhead
    check_head_width(hd, "attention")
    if qkv.data_ptr() % 16:
        raise ValueError("attention kernel needs a 16-byte aligned qkv")
    if stats is not None:
        _check(stats, "stats", torch.float32, 3)
        if tuple(stats.shape) != (2, M, nhead):
            raise ValueError(f"stats is {tuple(stats.shape)}, want {(2, M, nhead)}")
    out = torch.empty(M, D, dtype=out_dtype, device=qkv.device)
    err = _build.library().cse_attention(
        qkv.data_ptr(), out.data_ptr(), mode, M // seq_len, seq_len, nhead, hd, 1.0 / math.sqrt(hd),
        None if stats is None else stats.data_ptr(), _stream())
    _check_launch("attention", err)
    attention.launches += 1
    return out


def attention_info(seq_len: int, hd: int = 32, out_dtype=torch.bfloat16) -> dict:
    """How :func:`attention` launches the bf16 attention (bf16 or fp32 out)
    at this L and head width: see :func:`cse_tpu_torch.ops._build.launch_info`
    ("strip" for L <= 256)."""
    check_head_width(hd, "attention")
    mode = ATT_MODES[(torch.bfloat16, out_dtype)]
    return _build.launch_info("cse_attention_info", mode, seq_len, hd)


KERNELS = {"layer_norm": layer_norm, "linear": linear, "attention": attention}


def reset_launches():
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


reset_launches()


def launches_per_stack(n_layers: int, quant: str | None = None, d_model: int = 256,
                       d_ffn: int = 1024) -> dict[str, int]:
    """Launches one stack call makes at these widths: per layer 2 LN + 4 GEMM
    + 1 attention, plus the final LN; with ``quant="w8a8"``
    (:mod:`cse_tpu_torch.ops.fused_stack_w8a8`, its ``stack_route``) on the
    "fused" route (D 256, F 1024) per layer 2 LNs that write int8, the QKV
    and out-proj int8 GEMMs, the attention output's row quantizer, 1
    attention and 1 FFN kernel, plus the final LN; on the "chain" route (any
    other width) per layer 2 LNs, 4 int8 GEMMs, 4 row quantizers (the two
    LNs', the attention output's, the FFN hidden's) and 1 attention, plus
    the final LN."""
    if quant == "w8a8":
        from cse_tpu_torch.ops import fused_stack_w8a8 as w8

        if w8.stack_route(d_model, d_ffn) == "fused":
            return {"layer_norm": 1, "layer_norm_quant": 2 * n_layers, "attention": n_layers,
                    "quantize_rows": n_layers, "linear_w8a8": 2 * n_layers, "ffn_w8a8": n_layers}
        return {"layer_norm": 2 * n_layers + 1, "attention": n_layers, "quantize_rows": 4 * n_layers,
                "linear_w8a8": 4 * n_layers}
    return {"layer_norm": 2 * n_layers + 1, "linear": 4 * n_layers, "attention": n_layers}


# ---------------------------------------------------------------- the stack


def run_layer(r, w, li, seq_len, nhead, cd, ln, lin, attn):
    """One pre-LN layer on the fp32 residual ``r [G*L, D]``, updated in place:
    r += Wo.MHSA(LN1(r)); r += W2.relu(W1.LN2(r)). ``w`` holds ``[n, ...]``
    stacked weights (matrices ``[din, dout]`` in cd, vectors in r's type)."""
    h = ln(r, w["ln1_s"][li], w["ln1_b"][li], cd)
    qkv = lin(h, w["qkv_w"][li], w["qkv_b"][li], "bias")
    a = attn(qkv, seq_len, nhead, cd)
    lin(a, w["out_w"][li], w["out_b"][li], "residual", r)
    h = ln(r, w["ln2_s"][li], w["ln2_b"][li], cd)
    f = lin(h, w["f1_w"][li], w["f1_b"][li], "relu")
    lin(f, w["f2_w"][li], w["f2_b"][li], "residual", r)


def _run_stack(x, w, nhead, cd, ln, lin, attn):
    G, L, D = x.shape
    out_dtype = x.dtype
    # rounded to cd, then carried in fp32 through all layers; a fresh copy,
    # since the residual epilogues update it in place
    r = x.to(cd).to(torch.float32, copy=True).reshape(G * L, D).contiguous()
    for li in range(w["qkv_w"].shape[0]):
        run_layer(r, w, li, L, nhead, cd, ln, lin, attn)
    return ln(r, w["fn_s"], w["fn_b"], out_dtype).reshape(G, L, D)


def fused_stack_reference(x, w, nhead: int, compute_dtype: torch.dtype, quant: str | None = None) -> torch.Tensor:
    """Plain PyTorch version of the whole ``_stack_kernel`` (or, with
    ``quant="w8a8"``, ``_stack_kernel_w8a8``) on any device.

    x: [G, L, D] (PE already added); w: :func:`stack_weights`. Every matmul
    operand is rounded to cd and multiplied in fp32 (set
    ``torch.backends.cuda.matmul.allow_tf32 = False`` on the card).
    """
    _check_quant(w, compute_dtype, quant)
    if quant == "w8a8":
        from cse_tpu_torch.ops import fused_stack_w8a8 as w8

        return w8.run_stack(x, w, nhead, compute_dtype, w8.PLAIN_OPS)
    return _run_stack(x, w, nhead, compute_dtype, layer_norm_plain, linear_plain, attention_plain)


def _check_quant(w, compute_dtype, quant):
    check_quant_mode(quant)
    want = torch.int8 if quant == "w8a8" else compute_dtype
    if w["qkv_w"].dtype != want:
        raise TypeError(f"stacked weights are {w['qkv_w'].dtype}, want {want} for compute_dtype "
                        f"{compute_dtype}, quant {quant!r}")


def fused_stack_apply(
    x: torch.Tensor,
    w: dict[str, torch.Tensor],
    nhead: int = 8,
    compute_dtype: torch.dtype = torch.bfloat16,
    quant: str | None = None,
) -> torch.Tensor:
    """Run a TransformerStack forward (no PE; final LN included).

    x: [G, L, D] sequences (all L positions real); w: :func:`stack_weights`
    for ``compute_dtype`` and ``quant``. CUDA tensors go through the kernels
    (:func:`launches_per_stack`: 57 launches at 8 layers, with or without
    ``quant="w8a8"`` at the model's widths), CPU tensors through
    :func:`fused_stack_reference`.
    Returns [G, L, D] in x's dtype.
    """
    if not _route(x, w["qkv_w"]):
        return fused_stack_reference(x, w, nhead, compute_dtype, quant)
    _check_quant(w, compute_dtype, quant)
    if quant == "w8a8":
        from cse_tpu_torch.ops import fused_stack_w8a8 as w8

        w8.check_widths(x.shape[-1], w["f1_w"].shape[-1], nhead)  # before the first launch
        return w8.run_stack(x, w, nhead, compute_dtype, w8.KERNEL_OPS)
    return _run_stack(x, w, nhead, compute_dtype, layer_norm, linear, attention)
