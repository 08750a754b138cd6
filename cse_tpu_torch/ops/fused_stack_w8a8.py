"""w8a8 inference forward of a TransformerStack through hand-written kernels.

Port of ``cse_tpu/ops/fused_stack.py::_stack_kernel_w8a8`` (:130, with
``_qdot`` :115). The four projections of each layer run int8 x int8 -> int32
with per-output-channel weight scales (:func:`fused_stack.quantize_stacked`)
and a dynamic scale per activation row; LayerNorm, softmax and the residual
stay fp32, and the attention's score and PV products stay in the compute
dtype (cd) with an fp32 output. On Hopper (``csrc/fused_stack_w8a8.cu``):

* :func:`quantize_rows`: fp32 ``[M, K]`` -> int8 ``[M, K]`` and fp32 ``sa[M]``,
  sa = max(max |h|, 1e-12) / 127, q = round-half-even(h / sa) with a true
  division: bit-exact against :func:`quantize_rows_plain`;
* :func:`linear_w8a8`: ``wgmma`` s8 x s8 -> s32 (TMA loads and stores, the
  weight read K-major as :func:`fused_stack.stack_weights` keeps it) and the
  epilogue y = acc * sa[row] * s[col] in fp32, then ``y + b`` (QKV), ``relu(y + b)``
  or ``(r + y) + b`` into the fp32 residual (out-proj), the association JAX
  writes (``x = x + _qdot(...) + b``);
* :func:`layer_norm_quant`: the LayerNorm (fp32, the arithmetic of
  :func:`fused_stack.layer_norm`'s kernel) and the row quantizer in one pass,
  writing int8 and ``sa``: both LNs of a layer;
* :func:`ffn_w8a8`: FFN1, ReLU, the hidden's quantizer and FFN2 into the
  residual in one kernel, the ``[M, 1024]`` hidden kept on chip;
* the serving stack's attention (bf16 operands, fp32 out) and final LN
  kernels of :mod:`cse_tpu_torch.ops.fused_stack`.

The stack's route is a function of its widths alone (:func:`stack_route`),
chosen before any launch. At the model's widths (D 256, F 1024), "fused":
per layer LN + quantize, QKV, attention, quantize, out-proj, LN + quantize,
FFN; then the final LN: 57 launches at 8 layers. At any other width, "chain"
(``layer_norm_quant`` and ``ffn_w8a8`` are built for the model's widths
only): each LN as :func:`fused_stack.layer_norm` (fp32 out) then
:func:`quantize_rows`, the FFN as :func:`linear_w8a8` (relu),
:func:`quantize_rows`, :func:`linear_w8a8` (residual): the same arithmetic in
more launches, 89 at 8 layers. A width no route takes raises before the
first launch (:func:`check_widths`, called by
:func:`fused_stack.fused_stack_apply`). Each wrapper counts its launches in
``launches``; a CPU tensor takes the plain version, anything else raises.
"""

from __future__ import annotations

import types

import torch

from cse_tpu_torch.ops import _build
from cse_tpu_torch.ops import fused_stack as fs

MAX_K = 1024  # |acc| <= 127^2 * K < 2^24: integer sums are exact in fp32
D_MODEL = 256  # the widths layer_norm_quant and ffn_w8a8 are built for: the model's
D_FFN = 1024


# ---------------------------------------------------------------- plain versions


def quantize_rows_plain(h):
    """fp32 ``h [M, K]`` -> (int8 ``[M, K]``, fp32 row scales ``sa [M]``)."""
    sa = fs.int8_scale(h.abs().amax(dim=-1, keepdim=True))
    return torch.round(h / sa).to(torch.int8), sa[:, 0]


def qdot_plain(hq, sa, w8, s):
    """``_qdot``'s contraction and scaling: acc = hq . w8 (exact: every
    partial sum is an integer below 2^24, so fp32 holds it in any order),
    y = acc * sa * s in fp32, in that order."""
    acc = hq.float() @ w8.float()
    return acc * sa[:, None] * s.reshape(1, -1)


def linear_w8a8_plain(hq, sa, w8, s, bias, epilogue, residual=None):
    """'bias' -> y + b; 'relu' -> relu(y + b); 'residual' -> (r + y) + b,
    in place into the fp32 ``residual`` (returned). y: :func:`qdot_plain`."""
    y = qdot_plain(hq, sa, w8, s)
    if epilogue == "bias":
        return y + bias
    if epilogue == "relu":
        return torch.relu(y + bias)
    if epilogue == "residual":
        return residual.add_(y).add_(bias)
    raise ValueError(f"unknown epilogue {epilogue!r}")


def layer_norm_quant_plain(x, scale, bias):
    """:func:`fused_stack.layer_norm_plain` in fp32, then
    :func:`quantize_rows_plain`: (int8 ``[M, D]``, fp32 ``sa [M]``)."""
    return quantize_rows_plain(fs.layer_norm_plain(x, scale, bias, torch.float32))


def ffn_w8a8_plain(hq, sa, w1, s1, b1, w2, s2, b2, residual):
    """The layer's FFN on its quantized LN2 output, into the fp32 ``residual``
    in place (returned): r = (r + qdot(relu(qdot(hq, w1) + b1), w2)) + b2,
    the hidden quantized by :func:`quantize_rows_plain` in between."""
    f = linear_w8a8_plain(hq, sa, w1, s1, b1, "relu")
    fq, sa2 = quantize_rows_plain(f)
    return linear_w8a8_plain(fq, sa2, w2, s2, b2, "residual", residual)


# ---------------------------------------------------------------- kernel wrappers


def quantize_rows(h):
    """See :func:`quantize_rows_plain`; kernel (a) on CUDA."""
    if not fs._route(h):
        return quantize_rows_plain(h)
    fs._check(h, "h", torch.float32, 2)
    M, K = h.shape
    hq = torch.empty(M, K, dtype=torch.int8, device=h.device)
    sa = torch.empty(M, dtype=torch.float32, device=h.device)
    err = _build.library().cse_quantize_rows(h.data_ptr(), hq.data_ptr(), sa.data_ptr(), M, K, fs._stream())
    fs._check_launch("quantize_rows", err)
    quantize_rows.launches += 1
    return hq, sa


def linear_w8a8(hq, sa, w8, s, bias, epilogue, residual=None):
    """See :func:`linear_w8a8_plain`; kernel (b) on CUDA. ``w8`` is
    ``[K, N]`` int8 stored K-major (:func:`fused_stack.k_major`: ``w8.t()``
    contiguous, each output channel's K bytes together), the layout the
    kernel reads; no call copies it."""
    if not fs._route(hq, sa, w8, s, bias, residual):
        return linear_w8a8_plain(hq, sa, w8, s, bias, epilogue, residual)
    fs._check(hq, "hq", torch.int8, 2)
    fs._check(sa, "sa", torch.float32, 1)
    fs._check(w8.t(), "w8.t() (w8 stored K-major, fused_stack.k_major)", torch.int8, 2)
    fs._check(s, "s", torch.float32)
    fs._check(bias, "bias", torch.float32, 1)
    (M, K), (K2, N) = hq.shape, w8.shape
    if K2 != K or sa.numel() != M or s.numel() != N or bias.numel() != N:
        raise ValueError(f"shapes hq {tuple(hq.shape)}, sa {tuple(sa.shape)}, w8 {tuple(w8.shape)}, "
                         f"s {tuple(s.shape)}, bias {tuple(bias.shape)}")
    if K % 16 or N % 8 or K > MAX_K or hq.data_ptr() % 16:
        raise ValueError(f"int8 GEMM kernel needs K % 16 == 0, K <= {MAX_K}, N % 8 == 0 and a 16-byte "
                         f"aligned hq; got K={K}, N={N}")
    if epilogue in ("bias", "relu"):
        out = torch.empty(M, N, dtype=torch.float32, device=hq.device)
    elif epilogue == "residual":
        fs._check(residual, "residual", torch.float32, 2)
        if tuple(residual.shape) != (M, N):
            raise ValueError(f"residual is {tuple(residual.shape)}, want {(M, N)}")
        out = residual
    else:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if w8.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("int8 GEMM kernel needs 16-byte aligned w8 and output")
    err = _build.library().cse_linear_w8a8(
        hq.data_ptr(), sa.data_ptr(), w8.data_ptr(), s.data_ptr(), bias.data_ptr(), out.data_ptr(),
        fs.EPILOGUES[epilogue], M, N, K, fs._stream())
    fs._check_launch("linear_w8a8", err)
    linear_w8a8.launches += 1
    return out


def _check_vector(t, name, n):
    fs._check(t, name, torch.float32)
    if t.numel() != n:
        raise ValueError(f"{name} has {t.numel()} entries, want {n}")


def layer_norm_quant(x, scale, bias):
    """See :func:`layer_norm_quant_plain`; kernel (c) on CUDA, D = 256 only.
    The LN values are those of :func:`fused_stack.layer_norm`'s fp32 output
    bit for bit, so the result equals ``quantize_rows(layer_norm(x, fp32))``."""
    if not fs._route(x, scale, bias):
        return layer_norm_quant_plain(x, scale, bias)
    fs._check(x, "x", torch.float32, 2)
    M, D = x.shape
    if D != D_MODEL:
        raise ValueError(f"layer_norm_quant kernel takes D = {D_MODEL}, got {D}")
    _check_vector(scale, "scale", D)
    _check_vector(bias, "bias", D)
    if x.data_ptr() % 16:
        raise ValueError("layer_norm_quant kernel needs a 16-byte aligned x")
    hq = torch.empty(M, D, dtype=torch.int8, device=x.device)
    sa = torch.empty(M, dtype=torch.float32, device=x.device)
    err = _build.library().cse_layer_norm_quant(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), hq.data_ptr(),
                                                sa.data_ptr(), M, D, fs.LN_EPS, fs._stream())
    fs._check_launch("layer_norm_quant", err)
    layer_norm_quant.launches += 1
    return hq, sa


def ffn_w8a8(hq, sa, w1, s1, b1, w2, s2, b2, residual):
    """See :func:`ffn_w8a8_plain`; kernel (d) on CUDA, at D = 256 and F =
    1024 only. ``w1 [D, F]`` and ``w2 [F, D]`` are int8 stored K-major
    (:func:`fused_stack.k_major`), as :func:`linear_w8a8` takes them. The
    same bits as :func:`linear_w8a8` (relu), :func:`quantize_rows` and
    :func:`linear_w8a8` (residual) in turn."""
    if not fs._route(hq, sa, w1, s1, b1, w2, s2, b2, residual):
        return ffn_w8a8_plain(hq, sa, w1, s1, b1, w2, s2, b2, residual)
    fs._check(hq, "hq", torch.int8, 2)
    M, D = hq.shape
    if D != D_MODEL or tuple(w1.shape) != (D, D_FFN) or tuple(w2.shape) != (D_FFN, D):
        raise ValueError(f"ffn_w8a8 kernel takes D = {D_MODEL}, F = {D_FFN}; got hq {tuple(hq.shape)}, "
                         f"w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    fs._check(w1.t(), "w1.t() (w1 stored K-major, fused_stack.k_major)", torch.int8, 2)
    fs._check(w2.t(), "w2.t() (w2 stored K-major, fused_stack.k_major)", torch.int8, 2)
    for t, name, n in ((sa, "sa", M), (s1, "s1", D_FFN), (b1, "b1", D_FFN), (s2, "s2", D), (b2, "b2", D)):
        _check_vector(t, name, n)
    fs._check(residual, "residual", torch.float32, 2)
    if tuple(residual.shape) != (M, D):
        raise ValueError(f"residual is {tuple(residual.shape)}, want {(M, D)}")
    if any(t.data_ptr() % 16 for t in (hq, w1, w2, residual)):
        raise ValueError("ffn_w8a8 kernel needs 16-byte aligned hq, w1, w2 and residual")
    err = _build.library().cse_ffn_w8a8(
        hq.data_ptr(), sa.data_ptr(), w1.data_ptr(), s1.data_ptr(), b1.data_ptr(), w2.data_ptr(), s2.data_ptr(),
        b2.data_ptr(), residual.data_ptr(), M, D, D_FFN, fs._stream())
    fs._check_launch("ffn_w8a8", err)
    ffn_w8a8.launches += 1
    return residual


# what cse_w8a8_kernel_info writes, in order
KERNEL_INFO_KEYS = ("registers", "local_bytes", "blocks_per_sm")


def kernel_info(name: str) -> dict:
    """Registers and local-memory bytes a thread and resident blocks per SM
    of ``"layer_norm_quant"`` or ``"ffn_w8a8"``'s kernel (on the card)."""
    return _build.query("cse_w8a8_kernel_info", KERNEL_INFO_KEYS, ("layer_norm_quant", "ffn_w8a8").index(name))


KERNELS = {"quantize_rows": quantize_rows, "linear_w8a8": linear_w8a8, "layer_norm_quant": layer_norm_quant,
           "ffn_w8a8": ffn_w8a8}


def reset_launches():
    """Zero these wrappers' counts and :mod:`fused_stack`'s."""
    fs.reset_launches()
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    """Calls of the w8a8 stack's kernel wrappers (LN and attention are
    :mod:`fused_stack`'s) since the reset; zero counts left out."""
    counts = {**fs.launch_counts(), **{name: fn.launches for name, fn in KERNELS.items()}}
    return {k: v for k, v in counts.items() if v}


reset_launches()


def stack_route(d_model: int, d_ffn: int) -> str:
    """The w8a8 stack's route at these widths: "fused" (``layer_norm_quant``
    and ``ffn_w8a8``) at D = 256, F = 1024, the widths those kernels are
    built for; "chain" (LN, quantizer and int8 GEMM launches) at any other."""
    return "fused" if (d_model, d_ffn) == (D_MODEL, D_FFN) else "chain"


def check_widths(d_model: int, d_ffn: int, nhead: int):
    """Raise ``ValueError`` unless the kernels of the stack's route take
    these widths: the int8 GEMM's K (D and F) % 16 == 0 and <= MAX_K (its
    N, 3D, D and F, are then multiples of 8), and a head width the
    attention is instantiated for."""
    if d_model % nhead:
        raise ValueError(f"d_model {d_model} does not split into {nhead} heads")
    fs.check_head_width(d_model // nhead, "attention")
    for k in (d_model, d_ffn):
        if k % 16 or k > MAX_K:
            raise ValueError(f"the w8a8 stack's int8 GEMM needs K % 16 == 0, K <= {MAX_K}; got d_model "
                             f"{d_model}, d_ffn {d_ffn}")


KERNEL_OPS = types.SimpleNamespace(ln=fs.layer_norm, lnq=layer_norm_quant, quant=quantize_rows, lin=linear_w8a8,
                                   attn=fs.attention, ffn=ffn_w8a8)
PLAIN_OPS = types.SimpleNamespace(ln=fs.layer_norm_plain, lnq=layer_norm_quant_plain, quant=quantize_rows_plain,
                                  lin=linear_w8a8_plain, attn=fs.attention_plain, ffn=ffn_w8a8_plain)


# ---------------------------------------------------------------- the stack


def run_stack(x, w, nhead, cd, ops):
    """``_stack_kernel_w8a8`` on x ``[G, L, D]`` (PE added) with
    :func:`fused_stack.stack_weights` ``(..., quant="w8a8")``, on the route
    :func:`stack_route` chooses for its widths; the result in x's dtype."""
    G, L, D = x.shape
    fused = stack_route(D, w["f1_w"].shape[-1]) == "fused"
    f32 = torch.float32
    r = x.to(cd).to(f32, copy=True).reshape(G * L, D).contiguous()  # updated in place

    def lin(hq, sa, name, li, epilogue, residual=None):
        return ops.lin(hq, sa, w[f"{name}_w"][li], w[f"{name}_s"][li], w[f"{name}_b"][li], epilogue, residual)

    def lnq(name, li):  # LN of the residual, quantized: (int8, row scales)
        s, b = w[f"{name}_s"][li], w[f"{name}_b"][li]
        return ops.lnq(r, s, b) if fused else ops.quant(ops.ln(r, s, b, f32))

    for li in range(w["qkv_w"].shape[0]):
        qkv = lin(*lnq("ln1", li), "qkv", li, "bias")
        a = ops.attn(qkv, L, nhead, f32, operand_dtype=cd)
        lin(*ops.quant(a), "out", li, "residual", r)
        hq, sa = lnq("ln2", li)
        if fused:
            ops.ffn(hq, sa, *(w[k][li] for k in ("f1_w", "f1_s", "f1_b", "f2_w", "f2_s", "f2_b")), r)
        else:
            lin(*ops.quant(lin(hq, sa, "f1", li, "relu")), "f2", li, "residual", r)
    return ops.ln(r, w["fn_s"], w["fn_b"], x.dtype).reshape(G, L, D)
