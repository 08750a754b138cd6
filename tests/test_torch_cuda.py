"""cse_tpu_torch's CUDA kernels against their plain versions, on the card.

Imports neither JAX nor cse_tpu, so it runs where only the port is
installed: ``python -m pytest --noconftest -q tests/test_torch_cuda.py``.
Every test is marked ``cuda`` and skips when torch.cuda.is_available() is
False. Tolerances: fp32, max error over max |ref| <= 1e-4 (only the
summation order differs); bf16, relative L2 <= 1e-2 (the same values are
rounded; accumulation order flips a few roundings).
"""

import math

import numpy as np
import pytest
import torch

from cse_tpu_torch.ops import fused_stack as fs
from cse_tpu_torch.ops import fused_train as ft

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, cd):
    a, b = got.float().cpu().numpy(), want.float().cpu().numpy()
    assert np.isfinite(a).all()
    if cd == torch.float32:
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()
    else:
        assert np.linalg.norm(a - b) / np.linalg.norm(b) <= 1e-2


def _stack(gen, cd, d=256, ffn=1024, n_layers=2):
    def r(*s, scale=1.0):
        return torch.randn(*s, device="cuda", generator=gen) * scale

    mats = {"qkv_w": (d, 3 * d), "out_w": (d, d), "f1_w": (d, ffn), "f2_w": (ffn, d)}
    w = {k: r(n_layers, *s, scale=1 / math.sqrt(s[0])).to(cd).contiguous() for k, s in mats.items()}
    for k, n in (("qkv_b", 3 * d), ("out_b", d), ("f1_b", ffn), ("f2_b", d), ("ln1_b", d), ("ln2_b", d)):
        w[k] = (0.1 * r(n_layers, n)).to(cd).float()
    for k in ("ln1_s", "ln2_s"):
        w[k] = (1 + 0.1 * r(n_layers, d)).to(cd).float()
    w["fn_s"], w["fn_b"] = (1 + 0.1 * r(d)).to(cd).float(), (0.1 * r(d)).to(cd).float()
    return w


@pytest.mark.parametrize("cd", DTYPES)
@pytest.mark.parametrize("seq_len", [1, 7, 127, 251, 300, 513])
def test_attention_matches_plain(gen, cd, seq_len):
    """Any length: one key tile (<= 256) or several (300, 513)."""
    qkv = 2 * torch.randn(5 * seq_len, 768, device="cuda", generator=gen)
    _close(fs.attention(qkv, seq_len, 8, cd), fs.attention_plain(qkv, seq_len, 8, cd), cd)


# the GEMM's shapes: the main path's (K, N) pairs (QKV, out-proj, FFN1, FFN2),
# the backward's dX products, ragged M (not a multiple of 128), several
# 128-row panels a block, the tiny model's widths (K = 32) and the JAX
# suite's (d_model 16, FFN 32: K 16 is a quarter of a 64-wide k-chunk)
LINEAR_SHAPES = [(1, 256, 256), (300, 256, 768), (1000, 1024, 256), (77, 40, 24), (1000, 256, 256),
                 (1000, 256, 1024), (1000, 768, 256), (40000, 256, 768), (77, 32, 32), (77, 32, 64), (77, 32, 96),
                 (300, 64, 96), (77, 16, 48), (77, 16, 16), (300, 16, 32), (300, 32, 16), (300, 48, 16)]


@pytest.mark.parametrize("cd", DTYPES)
@pytest.mark.parametrize("epilogue", ["bias", "relu", "residual"])
@pytest.mark.parametrize("mkn", LINEAR_SHAPES)
def test_linear_matches_plain(gen, cd, epilogue, mkn):
    m, k, n = mkn
    a = torch.randn(m, k, device="cuda", generator=gen).to(cd)
    w = (torch.randn(k, n, device="cuda", generator=gen) / math.sqrt(k)).to(cd)
    b = torch.randn(n, device="cuda", generator=gen)
    res = torch.randn(m, n, device="cuda", generator=gen) if epilogue == "residual" else None
    got = fs.linear(a, w, b, epilogue, None if res is None else res.clone())
    _close(got, fs.linear_plain(a, w, b, epilogue, res), cd)


@pytest.mark.parametrize("cd", DTYPES)
def test_layer_norm_matches_plain(gen, cd):
    x = 3 * torch.randn(999, 256, device="cuda", generator=gen)
    s, b = torch.rand(256, device="cuda", generator=gen) + 0.5, torch.randn(256, device="cuda", generator=gen)
    _close(fs.layer_norm(x, s, b, cd), fs.layer_norm_plain(x, s, b, cd), cd)


@pytest.mark.parametrize("cd", DTYPES)
def test_stack_matches_reference_and_counts(gen, cd):
    w = _stack(gen, cd)
    x = torch.randn(9, 300, 256, device="cuda", generator=gen).to(cd)
    fs.reset_launches()
    got = fs.fused_stack_apply(x, w, 8, cd)
    torch.cuda.synchronize()
    assert fs.launch_counts() == fs.launches_per_stack(2)
    assert got.dtype == cd and got.shape == x.shape
    _close(got, fs.fused_stack_reference(x, w, 8, cd), cd)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    qkv = torch.randn(10, 3 * 96, device="cuda", generator=gen)
    with pytest.raises(ValueError, match="head widths 4, 8, 16, 32, 64; got 12"):
        fs.attention(qkv, 5, 8, torch.float32)  # head width 12
    qkv4 = torch.randn(10, 3 * 32, device="cuda", generator=gen)  # head width 4 is taken
    for cd in DTYPES:
        _close(fs.attention(qkv4, 5, 8, cd), fs.attention_plain(qkv4, 5, 8, cd), cd)
    with pytest.raises(TypeError):
        fs.layer_norm(torch.randn(4, 256, device="cuda"), torch.ones(256, device="cuda"),
                      torch.zeros(256, device="cuda"), torch.float16)
    a = torch.randn(4, 12, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="K % 8"):
        fs.linear(a, torch.randn(12, 16, device="cuda").bfloat16(), torch.zeros(16, device="cuda"), "bias")


# ---------------------------------------------------------------- training kernels


def _train_weights(gen, cd, d=256, ffn=1024, n_layers=1):
    def r(*s, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(*s, device="cuda", generator=gen)).to(cd)

    mats = {"qkv_w": (d, 3 * d), "out_w": (d, d), "f1_w": (d, ffn), "f2_w": (ffn, d)}
    w = {k: r(n_layers, *s, scale=1 / math.sqrt(s[0])) for k, s in mats.items()}
    for k, n in (("qkv_b", 3 * d), ("out_b", d), ("f1_b", ffn), ("f2_b", d), ("ln1_b", d), ("ln2_b", d)):
        w[k] = r(n_layers, n, scale=0.1)
    for k in ("ln1_s", "ln2_s"):
        w[k] = r(n_layers, d, scale=0.1, shift=1.0)
    return w


HEAD_WIDTHS = [4, 8, 16, 32, 64]
KP_HEAD_WIDTHS = [8, 16, 32, 64]  # the kernel-parts tool's own widths


@pytest.mark.parametrize("out_dtype", DTYPES)
@pytest.mark.parametrize("seq_len", [1, 7, 127, 251, 256, 300])
@pytest.mark.parametrize("hd", HEAD_WIDTHS)
def test_attention_head_widths_match_plain(gen, hd, seq_len, out_dtype):
    """bf16 operands on the strip route (L <= 256) or the two-pass route
    (300), bf16 or fp32 out, without and with the row stats; and the fp32
    kernel, at every instantiated head width."""
    H = 4 if hd == 64 else 8
    qkv = 2 * torch.randn(5 * seq_len, 3 * H * hd, device="cuda", generator=gen)
    bf = torch.bfloat16
    _close(fs.attention(qkv, seq_len, H, out_dtype, operand_dtype=bf),
           fs.attention_plain(qkv, seq_len, H, out_dtype, operand_dtype=bf), bf)
    st, sp = (torch.empty(2, 5 * seq_len, H, device="cuda") for _ in range(2))
    _close(fs.attention(qkv, seq_len, H, out_dtype, st, bf), fs.attention_plain(qkv, seq_len, H, out_dtype, sp, bf), bf)
    _close(st, sp, torch.float32)
    if out_dtype == torch.float32:
        _close(fs.attention(qkv, seq_len, H, out_dtype), fs.attention_plain(qkv, seq_len, H, out_dtype), out_dtype)


@pytest.mark.parametrize("hd", HEAD_WIDTHS)
@pytest.mark.parametrize("seq_len", [127, 128, 251, 256])
def test_attention_strip_instantiations_spill_nothing(gen, seq_len, hd):
    """cse_attention runs the one-pass strip for L <= 256 with no local
    memory, in both output types; the two-pass route beyond."""
    for out_dtype in DTYPES:
        info = fs.attention_info(seq_len, hd, out_dtype)
        assert info["route"] == "strip" and info["key_blocks"] == (8 if seq_len <= 128 else 16)
        assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1
    assert fs.attention_info(300, hd)["route"] == "passes"


@pytest.mark.parametrize("cd", DTYPES)
@pytest.mark.parametrize("seq_len", [7, 127, 251, 300])
def test_attention_stats_match_plain(gen, cd, seq_len):
    qkv = 2 * torch.randn(5 * seq_len, 768, device="cuda", generator=gen)
    st, sp = (torch.empty(2, 5 * seq_len, 8, device="cuda") for _ in range(2))
    _close(fs.attention(qkv, seq_len, 8, cd, st), fs.attention_plain(qkv, seq_len, 8, cd, sp), cd)
    _close(st, sp, torch.float32)


def _attention_backward_case(gen, cd, seq_len, H, hd):
    """The kernel's dqkv and bias sums against the plain version's, and a
    repeat's bits against the first call's (fixed-order sums)."""
    M = 5 * seq_len
    qkv = 2 * torch.randn(M, 3 * H * hd, device="cuda", generator=gen)
    stats = torch.empty(2, M, H, device="cuda")
    fs.attention_plain(qkv, seq_len, H, cd, stats)
    dattn = torch.randn(M, H * hd, device="cuda", generator=gen)
    got, got_b = ft.attention_backward(qkv, dattn, stats, seq_len, H, cd)
    want, want_b = ft.attention_backward_plain(qkv, dattn, stats, seq_len, H, cd)
    assert got.dtype == cd and got.shape == (M, 3 * H * hd)
    _close(got, want, cd)
    _close(got_b, want_b, cd)
    again, again_b = ft.attention_backward(qkv, dattn, stats, seq_len, H, cd)
    assert torch.equal(again, got) and torch.equal(again_b, got_b)


@pytest.mark.parametrize("cd", DTYPES)
@pytest.mark.parametrize("seq_len", [1, 7, 127, 251, 300, 513])
def test_attention_backward_matches_plain(gen, cd, seq_len):
    """Any length: the bf16 strip (L <= 256), one tile of 64 rows, several,
    and several key tiles."""
    _attention_backward_case(gen, cd, seq_len, 8, 32)


@pytest.mark.parametrize("cd", DTYPES)
@pytest.mark.parametrize("seq_len", [1, 7, 50, 127, 128, 251, 256, 257, 300, 513])
@pytest.mark.parametrize("hd", HEAD_WIDTHS)
def test_attention_backward_head_widths_match_plain(gen, cd, seq_len, hd):
    """bf16: the strip route (L <= 256; 8 or 16 key blocks) and the two-kernel
    route (257, 300, 513); fp32 on its own kernels; every head width."""
    _attention_backward_case(gen, cd, seq_len, 4, hd)


@pytest.mark.parametrize("hd", HEAD_WIDTHS)
@pytest.mark.parametrize("seq_len", [1, 127, 128, 251, 256])
def test_attention_backward_strip_instantiations_spill_nothing(gen, seq_len, hd):
    """cse_attention_bwd runs the one-pass strip for bf16 at L <= 256 with no
    local memory; the two-kernel route beyond."""
    info = ft.attention_backward_info(seq_len, hd)
    assert info["route"] == "strip" and info["key_blocks"] == (8 if seq_len <= 128 else 16)
    assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1 and info["rows_per_block"] == seq_len
    assert ft.attention_backward_info(257, hd)["route"] == "passes"


# the main path's four (K, N) at M = 40000, the tiny model's (K 32 and 64),
# the JAX suite's (K 16 and 32 against N 48, 16, 32), ragged K and N below a
# tile, several slabs, and tiles of 128 and 256 columns
WGRAD_SHAPES = [(1000, 256, 768), (777, 1024, 256), (5000, 256, 256), (33, 40, 24), (40000, 256, 768),
                (40000, 256, 256), (40000, 256, 1024), (40000, 1024, 256), (3000, 32, 96), (3000, 32, 32),
                (3000, 32, 64), (3000, 64, 32), (3000, 16, 48), (3000, 16, 16), (3000, 16, 32), (3000, 32, 16),
                (3000, 48, 16)]


@pytest.mark.parametrize("cd", DTYPES)
@pytest.mark.parametrize("mkn", WGRAD_SHAPES)
def test_weight_grad_matches_plain_and_repeats(gen, cd, mkn):
    m, k, n = mkn
    a = torch.randn(m, k, device="cuda", generator=gen).to(cd)
    dy = torch.randn(m, n, device="cuda", generator=gen).to(cd)
    got = ft.weight_grad(a, dy)
    assert got.dtype == torch.float32 and got.shape == (k, n)
    _close(got, ft.weight_grad_plain(a, dy), cd)
    assert torch.equal(got, ft.weight_grad(a, dy))  # fixed-order sums: the same bits


@pytest.mark.parametrize("cd", DTYPES)
@pytest.mark.parametrize("mkn", [(1000, 256, 1024), (77, 40, 24), (40000, 256, 1024), (77, 32, 96), (300, 32, 64),
                                 (300, 16, 32)])
def test_linear_relu_grad_matches_plain(gen, cd, mkn):
    """Also: the column sums come from fixed-order per-tile partials, so a
    second run gives the same bits."""
    m, k, n = mkn
    dy = torch.randn(m, k, device="cuda", generator=gen).to(cd)
    wt = (torch.randn(k, n, device="cuda", generator=gen) / math.sqrt(k)).to(cd)
    mask = torch.relu(torch.randn(m, n, device="cuda", generator=gen)).to(cd)
    (got, got_s), (want, want_s) = ft.linear_relu_grad(dy, wt, mask), ft.linear_relu_grad_plain(dy, wt, mask)
    assert got.dtype == cd
    _close(got, want, cd)
    _close(got_s, want_s, cd)
    again, again_s = ft.linear_relu_grad(dy, wt, mask)
    assert torch.equal(again, got) and torch.equal(again_s, got_s)


@pytest.mark.parametrize("cd", DTYPES)
@pytest.mark.parametrize("g_dtype", DTYPES)
def test_layer_norm_backward_matches_plain(gen, cd, g_dtype):
    m, d = 3001, 256
    x = 3 * torch.randn(m, d, device="cuda", generator=gen)
    dh = torch.randn(m, d, device="cuda", generator=gen)
    s = 1 + 0.1 * torch.randn(d, device="cuda", generator=gen)
    g = torch.randn(m, d, device="cuda", generator=gen).to(g_dtype)
    o32, ocd, sums = ft.layer_norm_backward(dh, x, s, g, torch.empty(m, d, device="cuda"), cd)
    p32, pcd, psums = ft.layer_norm_backward_plain(dh, x, s, g, torch.empty(m, d, device="cuda"), cd)
    _close(o32, p32, torch.float32)
    _close(ocd, pcd, cd)
    _close(sums, psums, torch.float32)
    g32 = g.float()  # in place into an fp32 g_in
    o_in, _, _ = ft.layer_norm_backward(dh, x, s, g32, g32, None)
    assert o_in is g32
    _close(g32, p32, torch.float32)


@pytest.mark.parametrize("cd", DTYPES)
@pytest.mark.parametrize("g_dtype", DTYPES)
@pytest.mark.parametrize("m", [1, 7, 3001, 50003])
@pytest.mark.parametrize("d", [16, 32, 48, 64, 256])
def test_layer_norm_backward_widths_rows_and_repeats(gen, d, m, g_dtype, cd):
    """Both load paths (D 256: 16-byte accesses; 16 to 64: a column a lane,
    masked past D below 32 and at 48), a
    grid larger than the rows (1, 7), one smaller (3001) and one whose warps
    end one row apart (50003); g_out in place; the fixed-order sums give the
    same bits on a repeat."""
    x = 3 * torch.randn(m, d, device="cuda", generator=gen) + 0.5
    dh = torch.randn(m, d, device="cuda", generator=gen)
    s = 1 + 0.1 * torch.randn(d, device="cuda", generator=gen)
    g = torch.randn(m, d, device="cuda", generator=gen).to(g_dtype)
    first = ft.layer_norm_backward(dh, x, s, g, torch.empty(m, d, device="cuda"), cd)
    p32, pcd, psums = ft.layer_norm_backward_plain(dh, x, s, g, torch.empty(m, d, device="cuda"), cd)
    _close(first[0], p32, torch.float32)
    _close(first[1], pcd, cd)
    _close(first[2], psums, torch.float32)
    again = ft.layer_norm_backward(dh, x, s, g, torch.empty(m, d, device="cuda"), cd)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    g32 = g.float()  # in place into an fp32 g_in, no cd copy
    o_in, o_cd, sums = ft.layer_norm_backward(dh, x, s, g32, g32, None)
    assert o_in is g32 and o_cd is None
    _close(g32, p32, torch.float32)
    _close(sums, psums, torch.float32)


@pytest.mark.parametrize("cd", DTYPES)
def test_layer_norm_backward_unaligned_rows_take_the_narrow_path(gen, cd):
    """Tensors that are not 16-byte aligned at D 256 (a view one element into
    its storage) go through the column-a-lane kernel, on a grid sized by that
    kernel's occupancy, with the same results and the same bits on a repeat."""
    m, d = 3001, 256

    def unaligned(scale, shift=0.0):
        flat = scale * torch.randn(m * d + 1, device="cuda", generator=gen) + shift
        return flat[1:].view(m, d)

    x, dh, g = unaligned(3.0, 0.5), unaligned(1.0), unaligned(1.0)
    s = 1 + 0.1 * torch.randn(d, device="cuda", generator=gen)
    assert x.data_ptr() % 16 and dh.data_ptr() % 16
    o32, ocd, sums = ft.layer_norm_backward(dh, x, s, g, torch.empty(m, d, device="cuda"), cd)
    p32, pcd, psums = ft.layer_norm_backward_plain(dh, x, s, g, torch.empty(m, d, device="cuda"), cd)
    _close(o32, p32, torch.float32)
    _close(ocd, pcd, cd)
    _close(sums, psums, torch.float32)
    again = ft.layer_norm_backward(dh, x, s, g, torch.empty(m, d, device="cuda"), cd)
    assert all(torch.equal(a, b) for a, b in zip((o32, ocd, sums), again))
    narrow, wide = (ft.layer_norm_backward_info(m, d, torch.float32, cd, aligned) for aligned in (False, True))
    assert narrow["path"] == "narrow" and wide["path"] == "wide" and narrow["local_bytes"] == 0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert narrow["grid"] == min(sms * narrow["blocks_per_sm"], -(-m // narrow["rows_per_block"]))


@pytest.mark.parametrize("d", [16, 32, 48, 64, 128, 256])
def test_layer_norm_backward_launch(gen, d):
    """The persistent grid fills the card: blocks per SM from the occupancy
    query, no local memory, the wide path for D % 128 == 0."""
    info = ft.layer_norm_backward_info(506016, d)
    assert info["path"].startswith("wide") == (d % 128 == 0)
    assert info["blocks_per_sm"] >= 1 and info["local_bytes"] == 0 and info["threads"] == 256
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert info["grid"] == sms * info["blocks_per_sm"]
    assert info["rows_per_warp"] == -(-506016 // (info["grid"] * info["rows_per_block"]))


def _rel(a, b):
    return float(torch.linalg.vector_norm(a.double() - b.double()) / torch.linalg.vector_norm(b.double()))


@pytest.mark.parametrize("cd", DTYPES)
@pytest.mark.parametrize("seq_len", [127, 251])
def test_fused_layers_forward_backward_match_plain(gen, cd, seq_len):
    """fp32: kernels against plain at the fp32 bar. bf16: a weight gradient is
    a sum over all rows, and bf16 rounding flips between two summation orders
    move such a sum by about 1e-2 at a few hundred rows; so each bf16 result
    is held against the plain fp32 run, and the kernels' error may exceed the
    plain bf16 version's by at most 25% (+1e-3), as in chip_smoke.py."""
    w = _train_weights(gen, cd)
    x = torch.randn(6, seq_len, 256, device="cuda", generator=gen).to(cd)
    gy = torch.randn(6, seq_len, 256, device="cuda", generator=gen).to(cd)
    _close(ft.layers_forward(x, w, 8), ft.layers_forward(x, w, 8, ft.PLAIN_OPS), cd)
    ft.reset_launches()
    dx, dw = ft.layers_backward(x, gy, w, 8)
    torch.cuda.synchronize()
    rx, rw = ft.layers_backward(x, gy, w, 8, ft.PLAIN_OPS)
    got, plain = {"x": dx, **dw}, {"x": rx, **rw}
    ref = plain
    if cd == torch.bfloat16:
        fx, fw = ft.layers_backward(x.float(), gy.float(), {k: v.float() for k, v in w.items()}, 8, ft.PLAIN_OPS)
        ref = {"x": fx, **fw}
    for k in got:
        g, p, r = got[k], plain[k], ref[k]
        if k == "qkv_b":  # the key bias's gradient is zero up to rounding: compare q and v
            g, p, r = ft.qv_part(g), ft.qv_part(p), ft.qv_part(r)
        if cd == torch.float32:
            _close(g, p, cd)
        else:
            assert _rel(g, r) <= 1.25 * _rel(p, r) + 1e-3, (k, _rel(g, r), _rel(p, r))
    counts = ft.launch_counts()
    assert counts["attention_backward"] == 1 and counts["weight_grad"] == 4


def test_fused_stack_train_counts(gen):
    from cse_tpu_torch.models.sepformer import SepformerConfig, TransformerStack

    stack = TransformerStack(SepformerConfig(num_tf_layers=2)).cuda()
    x = torch.randn(4, 127, 256, device="cuda", generator=gen, requires_grad=True)
    ft.reset_launches()
    y = ft.fused_stack_train(x, stack, nhead=8, compute_dtype=torch.bfloat16)
    y.float().square().sum().backward()
    torch.cuda.synchronize()
    assert ft.launch_counts() == ft.launches_per_train_stack(2)
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in stack.parameters())


def test_optimizer_skips_non_finite_on_the_card(gen):
    from cse_tpu_torch.train.optimizer import build_optimizer

    params = [torch.randn(300, 7, device="cuda", generator=gen), torch.randn(5, device="cuda", generator=gen)]
    start = [p.clone() for p in params]
    opt = build_optimizer(1e-3)
    state = opt.init(params)
    for bad in (float("nan"), float("inf")):
        g = [torch.randn_like(p) for p in params]
        g[0][17, 3] = bad
        assert opt.step(params, g, state) is False
    assert all(torch.equal(p, s) for p, s in zip(params, start))
    assert (state.count, state.total_notfinite) == (0, 2)
    assert opt.step(params, [torch.randn_like(p) for p in params], state) is True
    assert state.count == 1 and not torch.equal(params[0], start[0])


# ---------------------------------------------------------------- flash attention


def _flash_inputs(gen, cd, bh, seq_len, dh):
    return [torch.randn(1, bh, seq_len, dh, device="cuda", generator=gen).to(cd) for _ in range(4)]


@pytest.mark.parametrize("cd", DTYPES)
@pytest.mark.parametrize("seq_len,dh", [(16, 32), (17, 32), (128, 32), (129, 32), (251, 32), (256, 32), (257, 32),
                                        (300, 32), (600, 32), (127, 16), (130, 64), (77, 48), (7, 8), (127, 8),
                                        (251, 8), (300, 8), (251, 16), (300, 16), (7, 4), (127, 4), (251, 4),
                                        (300, 4)])
def test_flash_forward_matches_plain(gen, cd, seq_len, dh):
    """Any length: bf16 on the strip route (L <= 128: 8 key blocks in
    registers, L <= 256: 16) or the three-pass route (257 and on, one key tile
    or several); head widths 8-64."""
    from cse_tpu_torch.ops import attention as at

    q, k, v, _ = _flash_inputs(gen, cd, 12, seq_len, dh)
    (o, lse), (po, plse) = at.flash_fwd(q, k, v), at.flash_fwd_plain(q, k, v)
    assert o.dtype == cd and lse.dtype == torch.float32
    _close(o, po, cd)
    _close(lse, plse, torch.float32)


@pytest.mark.parametrize("cd", DTYPES)
@pytest.mark.parametrize("seq_len,dh", [(17, 32), (251, 32), (300, 32), (600, 32), (127, 16), (130, 64), (77, 48),
                                        (7, 8), (251, 8), (300, 8), (251, 16), (7, 4), (251, 4), (300, 4)])
def test_flash_backward_matches_plain(gen, cd, seq_len, dh):
    from cse_tpu_torch.ops import attention as at

    q, k, v, do = _flash_inputs(gen, cd, 12, seq_len, dh)
    o, lse = at.flash_fwd_plain(q, k, v)
    for got, want in zip(at.flash_bwd(q, k, v, o, lse, do), at.flash_bwd_plain(q, k, v, o, lse, do)):
        assert got.dtype == cd
        _close(got, want, cd)


@pytest.mark.parametrize("seq_len", [1, 16, 127, 128, 129, 251, 256, 257])
@pytest.mark.parametrize("dh", [4, 8, 16, 32, 48, 64])
def test_flash_backward_strip_matches_plain_and_repeats(gen, seq_len, dh):
    """bf16 on the one-pass strip (L <= 256: 8 or 16 key strips) and the
    three-kernel route (257), every head width: the bf16 bar, and the same
    bits on a repeat (dq's key groups are added in a fixed order). At L = 1
    the softmax is 1 and o = v, so ds = p (dp - delta) scale is zero up to
    the rounding of one dot product taken in two orders: dq and dk are held
    to that rounding's size (1e-5 of |do| |v| |k| dh, or |q|), not to their
    own norm, which is noise in both versions."""
    from cse_tpu_torch.ops import attention as at

    cd = torch.bfloat16
    q, k, v, do = _flash_inputs(gen, cd, 12, seq_len, dh)
    o, lse = at.flash_fwd_plain(q, k, v)
    got = at.flash_bwd(q, k, v, o, lse, do)
    want = at.flash_bwd_plain(q, k, v, o, lse, do)
    for name, g, w, other in zip(("dq", "dk", "dv"), got, want, (k, q, None)):
        assert g.dtype == cd and g.shape == q.shape, name
        if seq_len == 1 and other is not None:
            size = do.float().abs().max() * v.float().abs().max() * other.float().abs().max() * dh
            assert g.float().abs().max() <= 1e-5 * size and w.float().abs().max() <= 1e-5 * size, name
        else:
            _close(g, w, cd)
    again = at.flash_bwd(q, k, v, o, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    assert at.flash_bwd_info(seq_len, dh)["route"] == ("strip" if seq_len <= at.STRIP_MAX_L else "passes")


@pytest.mark.parametrize("dh", [4, 8, 16, 32, 48, 64])
@pytest.mark.parametrize("seq_len", [128, 256])
def test_flash_backward_strip_instantiations_spill_nothing(gen, seq_len, dh):
    """Each L <= 256 instantiation of the backward's strip keeps its key
    strip's scores and gradients in registers: no local memory."""
    from cse_tpu_torch.ops import attention as at

    info = at.flash_bwd_info(seq_len, dh)
    assert info["route"] == "strip" and info["key_blocks"] == seq_len // 16
    assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1 and info["rows_per_block"] == seq_len
    assert at.flash_bwd_info(seq_len + 1, dh)["route"] == ("strip" if seq_len < 256 else "passes")


@pytest.mark.parametrize("dh", [4, 8, 16, 32, 48, 64])
@pytest.mark.parametrize("seq_len", [128, 256])
def test_flash_strip_instantiations_spill_nothing(gen, seq_len, dh):
    """Each L <= 256 instantiation keeps its score strip in registers: no
    local memory (cudaFuncGetAttributes.localSizeBytes)."""
    from cse_tpu_torch.ops import attention as at

    info = at.flash_fwd_info(seq_len, dh)
    assert info["route"] == "strip" and info["key_blocks"] == seq_len // 16
    assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1
    assert at.flash_fwd_info(seq_len + 1, dh)["route"] == ("strip" if seq_len < 256 else "passes")


def test_flash_refuses_head_widths_it_does_not_take(gen):
    from cse_tpu_torch.ops import attention as at

    for dh in (12, 40):
        q = torch.randn(1, 2, 9, dh, device="cuda", generator=gen)
        with pytest.raises(ValueError, match="head widths"):
            at.flash_fwd(q, q, q)
    for cd in DTYPES:  # head width 4 is taken
        q, k, v, do = _flash_inputs(gen, cd, 6, 9, 4)
        (o, lse), (po, plse) = at.flash_fwd(q, k, v), at.flash_fwd_plain(q, k, v)
        _close(o, po, cd)
        for got, want in zip(at.flash_bwd(q, k, v, po, plse, do), at.flash_bwd_plain(q, k, v, po, plse, do)):
            _close(got, want, cd)


def test_flash_model_step_counts(gen):
    """A flash + remat='layer' Sepformer forward and backward on the card
    launches each flash kernel as launches_per_step says."""
    from cse_tpu_torch.models.sepformer import Sepformer, SepformerConfig
    from cse_tpu_torch.ops import attention as at

    cfg = SepformerConfig(variant="context", num_tf_layers=2, num_dp_layers=1, use_flash_attention=True,
                          remat="layer", compute_dtype=torch.bfloat16)
    model = Sepformer(cfg, generator=torch.Generator().manual_seed(0)).cuda()
    mix = torch.randn(2, 8000, device="cuda", generator=gen)
    ctx = torch.randn(2, 1, 4096, device="cuda", generator=gen)
    at.reset_launches()
    model(mix, ctx).float().square().mean().backward()
    torch.cuda.synchronize()
    assert at.launch_counts() == at.launches_per_step(2 * cfg.num_tf_layers, True)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)


# ---------------------------------------------------------------- w8a8 serving


@pytest.mark.parametrize("mk", [(1, 256), (999, 256), (3001, 1024), (17, 48)])
def test_quantize_rows_is_bit_exact(gen, mk):
    from cse_tpu_torch.ops import fused_stack_w8a8 as w8

    h = 3 * torch.randn(*mk, device="cuda", generator=gen)
    h[0] = 0  # a zero row takes the 1e-12 floor
    (q, sa), (pq, psa) = w8.quantize_rows(h), w8.quantize_rows_plain(h)
    assert q.dtype == torch.int8 and torch.equal(q, pq) and torch.equal(sa, psa)


# the serving path's four (K, N) at intra M = 2016 x 251, small and ragged M,
# K (16, 32, 48, 64: one chunk below 128 bytes; 16 is half a wgmma s8 k-step)
# and N (16, 24, 32, 48, 96: below a tile), the chain route's products at the
# JAX suite's widths (d_model 16, FFN 32) and K 1024 streamed with one or two
# N tiles a pass
W8A8_SHAPES = [(1, 256, 256), (300, 256, 768), (1000, 1024, 256), (77, 48, 24), (1000, 32, 96), (777, 64, 256),
               (129, 1024, 96), (4000, 256, 1024), (2016 * 251, 256, 768), (2016 * 251, 256, 256),
               (2016 * 251, 256, 1024), (2016 * 251, 1024, 256), (77, 16, 48), (1000, 16, 16), (300, 16, 32),
               (300, 32, 16)]


@pytest.mark.parametrize("epilogue", ["bias", "relu", "residual"])
@pytest.mark.parametrize("mkn", W8A8_SHAPES)
def test_linear_w8a8_matches_plain(gen, epilogue, mkn):
    """Integer sums are exact and the epilogue rounds each step as the plain
    version does: max_rel <= 1e-6. The weight is K-major (fs.k_major), as
    stack_weights keeps it; a row-major one is refused."""
    from cse_tpu_torch.ops import fused_stack_w8a8 as w8

    m, k, n = mkn
    hq, sa = w8.quantize_rows(torch.randn(m, k, device="cuda", generator=gen))
    wq = fs.k_major(torch.randint(-127, 128, (k, n), device="cuda", generator=gen, dtype=torch.int8))
    s = (torch.rand(1, n, device="cuda", generator=gen) + 0.1) / 100
    b = torch.randn(n, device="cuda", generator=gen)
    res = torch.randn(m, n, device="cuda", generator=gen) if epilogue == "residual" else None
    got = w8.linear_w8a8(hq, sa, wq, s, b, epilogue, None if res is None else res.clone())
    want = w8.linear_w8a8_plain(hq, sa, wq, s, b, epilogue, res)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    if n > 8:
        with pytest.raises(ValueError, match="K-major"):
            w8.linear_w8a8(hq, sa, wq.contiguous(), s, b, epilogue, None if res is None else res.clone())


@pytest.mark.parametrize("m", [1, 7, 999, 2016 * 251])
def test_layer_norm_quant_matches_the_kernel_chain(gen, m):
    """LN and the quantizer in one kernel give the bits of layer_norm (fp32
    out) then quantize_rows, payload and scales; a constant row under a zero
    bias takes the 1e-12 floor; other widths are refused by the kernel, and
    the w8a8 stack takes the chain there instead."""
    from cse_tpu_torch.ops import fused_stack_w8a8 as w8

    x = 3 * torch.randn(m, 256, device="cuda", generator=gen) + 0.5
    x[0] = 2.5
    s = 1 + 0.1 * torch.randn(256, device="cuda", generator=gen)
    for b in (0.1 * torch.randn(256, device="cuda", generator=gen), torch.zeros(256, device="cuda")):
        q, sa = w8.layer_norm_quant(x, s, b)
        cq, csa = w8.quantize_rows(fs.layer_norm(x, s, b, torch.float32))
        assert q.dtype == torch.int8 and torch.equal(q, cq) and torch.equal(sa, csa)
    assert sa[0].item() == np.float32(1e-12) / np.float32(127.0) and not q[0].any()
    with pytest.raises(ValueError, match="D = 256"):
        w8.layer_norm_quant(x[:, :128].contiguous(), s[:128], b[:128])
    _w8a8_stack_case(gen, 128, 8, 512)  # the stack at D 128: the chain, not the kernel


def _w8a8_stack_case(gen, d, h, f):
    """A 2-layer w8a8 stack at (d, h, f) on the card: its launches those of
    the route stack_route chooses, its output within the bf16 bar of the plain
    stack on the same route."""
    from cse_tpu_torch.models.sepformer import SepformerConfig, TransformerStack
    from cse_tpu_torch.ops import fused_stack_w8a8 as w8

    stack = TransformerStack(SepformerConfig(d_model=d, nhead=h, d_ffn=f, num_tf_layers=2))
    w = {k: v.cuda() for k, v in fs.stack_weights(stack, torch.bfloat16, quant="w8a8").items()}
    x = torch.randn(9, 127, d, device="cuda", generator=gen).to(torch.bfloat16)
    w8.reset_launches()
    got = fs.fused_stack_apply(x, w, h, torch.bfloat16, quant="w8a8")
    torch.cuda.synchronize()
    want_counts = fs.launches_per_stack(2, "w8a8", d, f)
    assert w8.launch_counts() == want_counts
    assert ("ffn_w8a8" in want_counts) == (w8.stack_route(d, f) == "fused")
    _close(got, fs.fused_stack_reference(x, w, h, torch.bfloat16, quant="w8a8"), torch.bfloat16)


@pytest.mark.parametrize("dhf", [(16, 4, 32), (32, 4, 64), (256, 8, 1024)])
def test_w8a8_stack_routes_by_width(gen, dhf):
    """The JAX suite's widths (head width 4), --debug_tiny_model's and the
    paper's: the chain at the first two, layer_norm_quant and ffn_w8a8 at
    the last."""
    _w8a8_stack_case(gen, *dhf)


# ragged row counts around the kernel's units (64 rows a warpgroup, 128 a panel): one row, a unit less or more
# one, two panels, fewer panels than SMs (5000: 40), the serving cell's shortest intra stack (45,180 = 352 panels
# and a last one whose second unit has 60 rows), a last panel with a short second unit (700 panels + 100 rows),
# and the paper's inter and intra stacks
@pytest.mark.parametrize("m", [1, 63, 64, 65, 127, 128, 129, 1000, 5000, 45180, 128 * 700 + 100, 4000 * 127,
                               2016 * 251])
def test_ffn_w8a8_matches_the_kernel_chain_and_plain(gen, m):
    """The one-kernel FFN gives the bits of linear_w8a8 (relu), quantize_rows
    and linear_w8a8 (residual) in turn, and holds the int8 GEMM's bar
    (max_rel <= 1e-6) against its plain version; ragged units and panels
    included. A repeat gives the same bits."""
    from cse_tpu_torch.ops import fused_stack_w8a8 as w8

    hq, sa = w8.quantize_rows(torch.randn(m, 256, device="cuda", generator=gen))
    w1 = fs.k_major(torch.randint(-127, 128, (256, 1024), device="cuda", generator=gen, dtype=torch.int8))
    w2 = fs.k_major(torch.randint(-127, 128, (1024, 256), device="cuda", generator=gen, dtype=torch.int8))
    s1 = (torch.rand(1, 1024, device="cuda", generator=gen) + 0.1) / 1000
    s2 = (torch.rand(1, 256, device="cuda", generator=gen) + 0.1) / 1000
    b1, b2 = (0.1 * torch.randn(n, device="cuda", generator=gen) for n in (1024, 256))
    r = torch.randn(m, 256, device="cuda", generator=gen)
    got = w8.ffn_w8a8(hq, sa, w1, s1, b1, w2, s2, b2, r.clone())
    fq, fsa = w8.quantize_rows(w8.linear_w8a8(hq, sa, w1, s1, b1, "relu"))
    assert torch.equal(got, w8.linear_w8a8(fq, fsa, w2, s2, b2, "residual", r.clone()))
    assert torch.equal(got, w8.ffn_w8a8(hq, sa, w1, s1, b1, w2, s2, b2, r.clone()))
    want = w8.ffn_w8a8_plain(hq, sa, w1, s1, b1, w2, s2, b2, r.clone())
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


def test_ffn_w8a8_rounding_ties_take_the_true_division(gen):
    """Every 7th row's hidden lies exactly on the quantizer's rounding ties:
    hq = 1 at k 0 and 1, W1's first two rows 127 at column 0 and 0 or an odd
    value elsewhere, sa = s1 = 1 and b1 = 0, so y = acc, the row max 254 and
    sa2 = 2, and y / sa2 = j + 0.5. The kernel's second loop (quant_int, a
    true division rounded half to even) gives the chain's bits."""
    from cse_tpu_torch.ops import fused_stack_w8a8 as w8

    m = 1000
    hq = torch.randint(-127, 128, (m, 256), device="cuda", generator=gen, dtype=torch.int8)
    ties = torch.arange(0, m, 7, device="cuda")
    hq[ties] = 0
    hq[ties, :2] = 1
    w1 = torch.randint(-127, 128, (256, 1024), device="cuda", generator=gen, dtype=torch.int8)
    w1[0] = (torch.arange(1024, device="cuda") % 63 * 2 + 1).to(torch.int8)  # odd, 1 .. 125
    w1[1] = 0
    w1[:2, 0] = 127
    w1 = fs.k_major(w1)
    w2 = fs.k_major(torch.randint(-127, 128, (1024, 256), device="cuda", generator=gen, dtype=torch.int8))
    sa, s1, b1 = torch.ones(m, device="cuda"), torch.ones(1024, device="cuda"), torch.zeros(1024, device="cuda")
    s2 = (torch.rand(1, 256, device="cuda", generator=gen) + 0.1) / 1000
    b2 = 0.1 * torch.randn(256, device="cuda", generator=gen)
    r = torch.randn(m, 256, device="cuda", generator=gen)
    f = w8.linear_w8a8(hq, sa, w1, s1, b1, "relu")
    half = f[ties] / 2
    assert torch.equal(f[ties].amax(dim=1), torch.full((len(ties),), 254.0, device="cuda"))
    assert int((half - half.floor() == 0.5).sum()) >= len(ties) * 1000  # ties indeed
    fq, fsa = w8.quantize_rows(f)
    got = w8.ffn_w8a8(hq, sa, w1, s1, b1, w2, s2, b2, r.clone())
    assert torch.equal(got, w8.linear_w8a8(fq, fsa, w2, s2, b2, "residual", r.clone()))


def test_w8a8_kernels_spill_nothing(gen):
    from cse_tpu_torch.ops import fused_stack_w8a8 as w8

    for name in ("layer_norm_quant", "ffn_w8a8"):
        info = w8.kernel_info(name)
        assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1, (name, info)


@pytest.mark.parametrize("seq_len", [7, 251, 300])
def test_attention_fp32_output_matches_plain(gen, seq_len):
    qkv = 2 * torch.randn(5 * seq_len, 768, device="cuda", generator=gen)
    got = fs.attention(qkv, seq_len, 8, torch.float32, operand_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    _close(got, fs.attention_plain(qkv, seq_len, 8, torch.float32, operand_dtype=torch.bfloat16), torch.bfloat16)


@pytest.mark.parametrize("cd", DTYPES)
def test_w8a8_stack_matches_reference_and_counts(gen, cd):
    from cse_tpu_torch.models.sepformer import SepformerConfig, TransformerStack
    from cse_tpu_torch.ops import fused_stack_w8a8 as w8

    stack = TransformerStack(SepformerConfig(num_tf_layers=2))
    w = {k: v.cuda() for k, v in fs.stack_weights(stack, cd, quant="w8a8").items()}
    x = torch.randn(9, 300, 256, device="cuda", generator=gen).to(cd)
    w8.reset_launches()
    got = fs.fused_stack_apply(x, w, 8, cd, quant="w8a8")
    torch.cuda.synchronize()
    assert w8.launch_counts() == fs.launches_per_stack(2, "w8a8")
    assert got.dtype == cd and got.shape == x.shape
    _close(got, fs.fused_stack_reference(x, w, 8, cd, quant="w8a8"), torch.bfloat16)


# ---------------------------------------------------------------- the kernel-parts tool's kernels


def _kp_jmat(cd, d=256):
    return torch.full((d, 128), 1.0 / d, device="cuda").to(cd)


@pytest.mark.parametrize("cd", DTYPES)
@pytest.mark.parametrize("ln_mode", ["none", "centred", "cd", "exact", "x2"])
def test_kp_layer_norm_matches_plain(gen, cd, ln_mode):
    from cse_tpu_torch.ops import kernel_parts as kp

    x = 0.3 + 2 * torch.randn(1003, 256, device="cuda", generator=gen)
    x[5] = 0.5  # a constant row: var is exactly 0
    got, want = kp.kp_layer_norm(x, _kp_jmat(cd), ln_mode, cd), kp.kp_layer_norm_plain(x, _kp_jmat(cd), ln_mode, cd)
    assert got.dtype == cd
    if ln_mode != "none":  # 'none' is the cast alone
        assert float(got[5].float().abs().max()) == 0.0
    _close(got, want, cd)


@pytest.mark.parametrize("ln_mode", ["cd", "exact", "x2"])
@pytest.mark.parametrize("d,m", [(256, 1), (256, 63), (256, 1003), (256, 258048 + 37), (64, 1003), (512, 1003),
                                 (1024, 77)])
def test_kp_layer_norm_staged_matches_plain_and_repeats(gen, ln_mode, d, m):
    """The bf16 J modes on the staged kernel: tiles of 32 or 16 rows by D,
    the last one partial, a constant row, the same bits on a repeat."""
    from cse_tpu_torch.ops import kernel_parts as kp

    cd, j = torch.bfloat16, _kp_jmat(torch.bfloat16, d)
    x = 0.3 + 2 * torch.randn(m, d, device="cuda", generator=gen)
    x[m - 2 if m > 1 else 1:] = 0.5  # a constant row (not the only one): var is exactly 0
    got = kp.kp_layer_norm(x, j, ln_mode, cd)
    assert got.dtype == cd and (m == 1 or float(got[m - 2].float().abs().max()) == 0.0)
    _close(got, kp.kp_layer_norm_plain(x, j, ln_mode, cd), cd)
    assert torch.equal(got, kp.kp_layer_norm(x, j, ln_mode, cd))
    info = kp.kp_layer_norm_info(m, d, ln_mode)
    assert info["route"] == "staged" and info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1
    assert info["rows_per_block"] == (16 if d > 512 else 32)


@pytest.mark.parametrize("ln_mode", ["none", "centred"])
def test_kp_layer_norm_other_modes_take_rows(gen, ln_mode):
    from cse_tpu_torch.ops import kernel_parts as kp

    for cd in DTYPES:
        assert kp.kp_layer_norm_info(1003, 256, ln_mode, cd)["route"] == "rows"
    assert kp.kp_layer_norm_info(1003, 256, "exact", torch.float32)["route"] == "rows"


@pytest.mark.parametrize("cd", DTYPES)
@pytest.mark.parametrize("sm_mode,seq_len", [("skip", 256), ("sum", 256), ("cd", 256), ("ones", 256), ("x2", 256),
                                             ("skip", 7), ("sum", 127), ("sum", 300), ("ones", 513),
                                             ("sum", 128), ("sum", 255), ("sum", 257),
                                             ("skip", 128), ("skip", 255), ("skip", 257)])
def test_kp_attention_matches_plain(gen, cd, sm_mode, seq_len):
    """Each softmax mode at the tool's length, and the modes free of jmat at
    other lengths: bf16 on the one-pass route (L <= 128, <= 256) or the
    multi-pass one (257 and on, one key tile or several). The bf16 kernel
    rounds the score operands to bf16, and so does the plain version it is
    held against."""
    from cse_tpu_torch.ops import kernel_parts as kp

    G = 3
    qkv = torch.randn(G * seq_len, 768, device="cuda", generator=gen)
    x = torch.randn(G * seq_len, 256, device="cuda", generator=gen)
    got = kp.kp_attention(qkv, _kp_jmat(cd), x.clone(), seq_len, 8, sm_mode, cd)
    want = kp.kp_attention_plain(qkv, _kp_jmat(cd), x.clone(), seq_len, 8, sm_mode, cd,
                                 qk_dtype=None if cd == torch.float32 else cd)
    _close(got - x, want - x, cd)


@pytest.mark.parametrize("cd", DTYPES)
@pytest.mark.parametrize("sm_mode,seq_len", [("sum", 127), ("sum", 251), ("sum", 300), ("skip", 251)])
@pytest.mark.parametrize("hd", [8, 16, 64])
def test_kp_attention_head_widths_match_plain(gen, cd, hd, sm_mode, seq_len):
    from cse_tpu_torch.ops import kernel_parts as kp

    G, H = 3, 4
    D = H * hd
    qkv = torch.randn(G * seq_len, 3 * D, device="cuda", generator=gen)
    x = torch.randn(G * seq_len, D, device="cuda", generator=gen)
    got = kp.kp_attention(qkv, _kp_jmat(cd), x.clone(), seq_len, H, sm_mode, cd)
    want = kp.kp_attention_plain(qkv, _kp_jmat(cd), x.clone(), seq_len, H, sm_mode, cd,
                                 qk_dtype=None if cd == torch.float32 else cd)
    _close(got - x, want - x, cd)


@pytest.mark.parametrize("seq_len", [128, 256])
@pytest.mark.parametrize("sm_mode", ["skip", "sum", "cd", "x2"])
@pytest.mark.parametrize("hd", KP_HEAD_WIDTHS)
def test_kp_attention_one_pass_instantiations_spill_nothing(gen, sm_mode, seq_len, hd):
    from cse_tpu_torch.ops import kernel_parts as kp

    info = kp.kp_attention_info(seq_len, sm_mode, hd)
    assert info["route"] == "strip" and info["key_blocks"] == seq_len // 16
    assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1


@pytest.mark.parametrize("cd", DTYPES)
@pytest.mark.parametrize("mode", ["full", "matmul_only", "no_softmax", "ln_matmul", "softmax_matmul", "combined",
                                  "combined_hp", "combined_x2"])
def test_kernel_parts_apply_matches_plain_and_counts(gen, cd, mode):
    from cse_tpu_torch.ops import kernel_parts as kp
    from cse_tpu_torch.scripts.bench_kernel_parts import make_inputs

    args = make_inputs(5, 256, 256, 2, cd)
    kp.reset_launches()
    got = kp.kernel_parts_apply(*args, mode, 8)
    assert kp.launch_counts() == kp.launches_per_call(2)
    want = kp.kernel_parts_plain(*args, mode, 8, qk_dtype=None if cd == torch.float32 else cd)
    assert kp.launch_counts() == kp.launches_per_call(2)  # the plain version launches nothing
    a, b = got.cpu().numpy(), want.cpu().numpy()
    assert np.isfinite(a).all() and got.dtype == torch.float32
    assert np.linalg.norm(a - b) / np.linalg.norm(b) <= (1e-5 if cd == torch.float32 else 1e-2)


def test_kernel_parts_wrappers_refuse_what_the_kernels_do_not_take(gen):
    from cse_tpu_torch.ops import kernel_parts as kp

    j = _kp_jmat(torch.bfloat16)
    with pytest.raises(ValueError, match="head widths 8, 16, 32, 64; got 12"):
        kp.kp_attention(torch.zeros(64, 3 * 96, device="cuda"), j, torch.zeros(64, 96, device="cuda"), 64, 8, "sum",
                        torch.bfloat16)
    with pytest.raises(ValueError, match="jmat"):  # the jmat softmax sums need a row of jmat per key
        kp.kp_attention(torch.zeros(600, 768, device="cuda"), j, torch.zeros(600, 256, device="cuda"), 300, 8, "cd",
                        torch.bfloat16)
    with pytest.raises(TypeError):
        kp.kp_layer_norm(torch.zeros(4, 256, device="cuda"), j.half(), "centred", torch.float16)
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        kp.kp_layer_norm(torch.zeros(4, 256, device="cuda"), j.cpu(), "centred", torch.bfloat16)
    for ln_mode in ("cd", "exact", "x2"):  # the bf16 J modes' staged kernel: D % 16 == 0, D <= 1024, aligned x
        for d in (40, 2048):
            with pytest.raises(ValueError, match="D % 16 == 0"):
                kp.kp_layer_norm(torch.zeros(4, d, device="cuda"), _kp_jmat(torch.bfloat16, d), ln_mode,
                                 torch.bfloat16)
        with pytest.raises(ValueError, match="16-byte aligned"):
            kp.kp_layer_norm(torch.zeros(4 * 256 + 1, device="cuda")[1:].view(4, 256), j, ln_mode, torch.bfloat16)


@pytest.mark.parametrize("path", [[], ["--no_fused_train", "--flash_attention", "--remat", "layer"]])
def test_trainer_on_the_card_tiny(gen, tmp_path, path):
    """train_net on the card at the tiny width (head width 8), on the card's
    default fused step and layer by layer with the flash kernels, and a
    checkpoint resumes."""
    from cse_tpu_torch.core.flags import parse_train_args
    from cse_tpu_torch.train.loop import train_net

    argv = ["--synthetic_smoke", "--debug_tiny_model", "--train_data", "dailytalk", "--tot_iters", "3",
            "--batch_size", "2", "--eval_step", "2", "--max_sp_len", "2", "--max_ctx_tokens", "16", "--workers", "2",
            *path, "--checkpoint_dir", str(tmp_path)]
    with torch.enable_grad():
        stats = {}
        model = train_net(parse_train_args(argv), "base", stats=stats)
        assert next(model.parameters()).device.type == "cuda" and stats["final_step"] == 4
        assert np.isfinite(stats["loss_reads"]).all() and len(list(tmp_path.glob("Epoch_*.ckpt"))) == 2
        stats = {}
        train_net(parse_train_args(argv + ["--resume", "--from_ckpt", "--tot_iters", "5"]), "base", stats=stats)
        assert stats["start_step"] == 4 and stats["final_step"] == 6


@pytest.mark.parametrize("quant", [None, "w8a8"])
def test_released_checkpoint_reloads_to_the_same_serving_bits(gen, tmp_path, monkeypatch, quant):
    """A model exported as a released checkpoint and read back gives the
    same bits through ServingEngine as the original (tiny widths, bf16)."""
    from cse_tpu_torch.compat.torch_export import save_torch_checkpoint
    from cse_tpu_torch.compat.torch_import import sepformer_from_state_dict
    from cse_tpu_torch.core.cli import TINY_MODEL
    from cse_tpu_torch.models import Sepformer, SepformerConfig
    from cse_tpu_torch.serving import ServingEngine
    from cse_tpu_torch.train import checkpoint as ckpt_lib

    cfg = SepformerConfig(variant="context", compute_dtype=torch.bfloat16, **TINY_MODEL)
    model = Sepformer(cfg, generator=torch.Generator().manual_seed(4))
    path = str(tmp_path / "released.ckpt")
    save_torch_checkpoint(path, model)
    back = Sepformer(cfg)
    back.load_state_dict(sepformer_from_state_dict(ckpt_lib.restore_checkpoint(path)["state_dict"],
                                                   cfg.num_dp_layers, cfg.num_tf_layers))
    mix = torch.randn(3, 16000, device="cuda", generator=gen)
    ctx = torch.randn(3, 1, cfg.llm_dim, device="cuda", generator=gen)
    fs.reset_launches()
    # the decoder's default cuDNN conv_transpose1d is not deterministic
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    a = ServingEngine(cfg, model, quant=quant)(mix, ctx)
    b = ServingEngine(cfg, back, quant=quant)(mix, ctx)
    assert torch.isfinite(a).all() and torch.equal(a, b)
    if quant is None:
        assert fs.launch_counts()["attention"] > 0  # the kernels ran, not their plain versions


@pytest.mark.parametrize("channels", [64, 1024])
def test_ecapa_and_enrollment_crop_card_match_cpu(gen, monkeypatch, channels):
    """The ECAPA-TDNN (no kernel of the port: cuDNN and cuFFT) and the
    stand-in on the card against the CPU on one module, TF32 off (fp32 bar:
    only the summation order differs); the enrollment crop on the same draws
    gives the same bits."""
    import copy

    from cse_tpu_torch.data.pipeline import crop_enrollment, draw_enrollment
    from cse_tpu_torch.models.ecapa import EcapaEncoder, EcapaTDNN
    from cse_tpu_torch.models.speaker_encoder import SpectralSpeakerEncoder

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cpu_gen = torch.Generator().manual_seed(6)
    module = EcapaTDNN(channels=channels, generator=cpu_gen)
    lens = torch.tensor([80000, 30000, 16000])
    wav = 0.3 * torch.randn(3, 80000, generator=cpu_gen) * (torch.arange(80000)[None, :] < lens[:, None])
    card = EcapaEncoder(module=copy.deepcopy(module), device="cuda")(wav, lens)
    assert card.device.type == "cuda" and card.shape == (3, 1, 192)
    _close(card, EcapaEncoder(module=module, device="cpu")(wav, lens), torch.float32)
    stand = SpectralSpeakerEncoder()
    _close(copy.deepcopy(stand).cuda()(wav, lens), stand(wav, lens), torch.float32)
    gt16k = torch.randn(4, 100000, generator=cpu_gen)
    glen = torch.tensor([100000, 40000, 9000, 0], dtype=torch.int32)
    seconds, u = draw_enrollment(4, torch.Generator().manual_seed(7))
    a, a_len = crop_enrollment(gt16k.cuda(), glen.cuda(), seconds.cuda(), u.cuda())
    b, b_len = crop_enrollment(gt16k, glen, seconds, u)
    assert torch.equal(a.cpu(), b) and torch.equal(a_len.cpu(), b_len)
    s_card, u_card = draw_enrollment(256, gen)
    assert s_card.device.type == "cuda" and 1 <= int(s_card.min()) and int(s_card.max()) <= 5


@pytest.mark.parametrize("timestamps", [False, True])
def test_whisper_card_matches_cpu(gen, monkeypatch, timestamps):
    """Whisper at the cascade's stub widths (no kernel of the port: cuBLAS,
    cuDNN and cuFFT) on the card against the CPU on one random checkout, TF32
    off: the log-mel, the encoder and a decoder step at the fp32 bar; the
    greedy decode the same tokens and lengths, sum_logprob within 1e-3,
    no_speech_prob within 1e-5; the detected language the same."""
    from cse_tpu_torch.models import whisper as tw

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = tw.WhisperConfig(n_audio_state=64, n_audio_head=4, n_audio_layer=2, n_text_state=64, n_text_head=4,
                           n_text_layer=2)
    cpu = tw.random_whisper(cfg, seed=3, device="cpu")
    card = tw.random_whisper(cfg, seed=3, device="cuda")
    wav = 0.2 * torch.randn(2, 16000 * 20, generator=torch.Generator().manual_seed(8))
    mel = tw.whisper_log_mel(wav)
    _close(tw.whisper_log_mel(wav.cuda()), mel, torch.float32)
    audio = tw.whisper_encode(cpu, mel)
    _close(tw.whisper_encode(card, mel.cuda()), audio, torch.float32)
    lang = torch.full((2,), cfg.token_lang_en)
    got = tw.whisper_decode_audio(card, audio.cuda(), lang, max_tokens=48, timestamps=timestamps)
    want = tw.whisper_decode_audio(cpu, audio, lang, max_tokens=48, timestamps=timestamps)
    assert got[0].device.type == "cuda"
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    np.testing.assert_allclose(got[2].cpu().numpy(), want[2].numpy(), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got[3].cpu().numpy(), want[3].numpy(), atol=1e-5)
    assert torch.equal(tw.whisper_detect_language_audio(card, audio.cuda())[0].cpu(),
                       tw.whisper_detect_language_audio(cpu, audio)[0])
