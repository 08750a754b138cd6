"""cse_tpu_torch.ops.mla: the MLA prefill attention of the DeepSeek-V2
history encoder.

CPU: the plain twin against a row-by-row fp32 softmax over each real query's
keys (rel L2 1e-5, fp32: only the summation order differs), at the encoder
tests' tiny widths (32, 16, 32) and at DeepSeek-V2's (128, 64, 128) with two
heads, T = 40 and left padding of 0, 7 and 39 tokens; pad rows finite; the
kernel's tile counts against a count over the dense mask; ``mla`` on the CPU
never reaches the kernel's wrapper.

Card (``cuda``, skipped without a GPU; ``python -m pytest --noconftest -q
tests/test_torch_mla.py``): the kernel against the plain twin on real rows
at the history cell's shape (B 10, T 2048, 16 heads, bf16) with paddings 0,
1, 127, 128, 129, 1500 and 2047 tokens, at the tiny widths and at a ragged
T. Tolerance: rel L2 1e-2 over real rows. Both round p and o to bf16
(2^-9 a value); the twin also rounds each score to bf16 before the fp32
scale (an absolute error of up to 0.02-0.06 at scores of 10-30 before the
scale), which the kernel does not: the kernel's gap to an fp32 computation
must not exceed the twin's. Pad rows exactly 0, repeats bit for bit, no
host sync.
"""

import pytest
import torch

from cse_tpu_torch.models import deepseek_v2 as dv
from cse_tpu_torch.ops import mla as M

torch.set_num_threads(1)

TINY_WIDTHS = (32, 16, 32)
FULL_WIDTHS = (128, 64, 128)
SCALE = dv.softmax_scale(dv.DeepseekV2Config())  # DeepSeek-V2-Lite's
BF16_TOL = 1e-2
# test_torch_deepseek_v2.py's tiny encoder (the kernel's tiny widths), drawn at the std that gives
# each layer the gain 0.02 gives at hidden 2048 (perfbench/tests/tiny_history.py's)
TINY = dv.DeepseekV2Config(vocab_size=320, hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
                           num_hidden_layers=3, num_attention_heads=4, n_routed_experts=8, n_shared_experts=1,
                           num_experts_per_tok=2, kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16,
                           v_head_dim=32, initializer_range=0.113)
PADS = (5, 0, 11, 2)


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _inputs(B, T, H, widths, dtype=torch.float32, device="cpu", seed=0):
    dn, dr, dv_ = widths
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(B, T, H * (dn + dr), generator=g, device=device).to(dtype)
    kv = torch.randn(B, T, H * (dn + dv_), generator=g, device=device).to(dtype)
    k_pe = torch.randn(B, T, dr, generator=g, device=device).to(dtype)
    return q, kv, k_pe


def _rowwise(q, kv, k_pe, first, scale, widths):
    """Each real query's softmax over keys first[b] .. i, one row at a time, fp32."""
    dn, dr, dv_ = widths
    B, T, _ = q.shape
    H = kv.shape[-1] // (dn + dv_)
    q4 = q.float().view(B, T, H, dn + dr)
    kv4 = kv.float().view(B, T, H, dn + dv_)
    out = torch.zeros(B, T, H, dv_)
    for b in range(B):
        f = int(first[b])
        for i in range(f, T):
            k = torch.cat([kv4[b, f:i + 1, :, :dn], k_pe.float()[b, f:i + 1, None].expand(-1, H, dr)], dim=-1)
            s = torch.einsum("hd,jhd->hj", q4[b, i], k) * scale
            out[b, i] = torch.einsum("hj,jhd->hd", torch.softmax(s, dim=-1), kv4[b, f:i + 1, :, dn:])
    return out.reshape(B, T, H * dv_)


@pytest.mark.parametrize("widths,H,T,pads", [(TINY_WIDTHS, 4, 12, (5, 0, 11, 2)),
                                             (FULL_WIDTHS, 2, 40, (0, 7, 39))])
def test_plain_twin_matches_a_rowwise_softmax_on_real_rows(widths, H, T, pads):
    q, kv, k_pe = _inputs(len(pads), T, H, widths)
    first = torch.tensor(pads, dtype=torch.int32)
    mask = M.mask_of_first(first, T)
    got = M.mla_attention_plain(q, kv, k_pe, M.attention_bias(mask), SCALE, widths)
    want = _rowwise(q, kv, k_pe, first, SCALE, widths)
    assert got.shape == want.shape
    assert _rel(got[mask], want[mask]) < 1e-5
    assert torch.isfinite(got).all()  # pad rows too: the finite bias gives them a softmax row
    # the wrapper on CPU tensors is the twin under the same mask, and launches nothing
    before = M.mla_attention.launches
    assert torch.equal(M.mla_attention(q, kv, k_pe, first, SCALE, widths), got)
    assert M.mla_attention.launches == before


def test_first_real_of_a_left_padded_mask():
    mask = torch.tensor([[0, 0, 1, 1, 1], [1, 1, 1, 1, 1], [0, 0, 0, 0, 1]], dtype=torch.bool)
    first = M.first_real(mask)
    assert first.dtype == torch.int32 and first.tolist() == [2, 0, 4]
    assert torch.equal(M.mask_of_first(first, 5), mask)


def _dense_counts(pads, T, tile):
    """(run, skipped) over a dense mask: a tile pair runs when any of its
    (query, key) pairs is live (first <= key <= query)."""
    i = torch.arange(T)
    n = -(-T // tile)
    run = 0
    for f in pads:
        live = (i[None] <= i[:, None]) & (i[None] >= f)
        for qt in range(n):
            for kt in range(n):
                run += int(live[qt * tile:(qt + 1) * tile, kt * tile:(kt + 1) * tile].any())
    return run, len(pads) * n * n - run


@pytest.mark.parametrize("T,tile,pads", [(40, 16, (0, 7, 39, 40)), (128, 128, (0, 1, 127)),
                                         (300, 128, (0, 128, 129, 299)), (2048, 128, (0, 1, 491, 1500, 2047)),
                                         (200, 64, (63, 64, 65, 150)), (12, 128, (5, 0, 11, 2))])
def test_tile_counts_match_a_count_over_the_dense_mask(T, tile, pads):
    run, skipped = M.tile_counts(torch.tensor(pads, dtype=torch.int32), T, tile)
    assert (int(run), int(skipped)) == _dense_counts(pads, T, tile)


def test_tile_counts_skip_the_causal_half_of_an_unpadded_row():
    run, skipped = M.tile_counts(torch.zeros(1, dtype=torch.int32), 2048)
    assert (int(run), int(skipped)) == (136, 120)  # 16 x 17 / 2 of 256: 46.9% skipped


def _tiny_batch():
    ids = torch.randint(0, TINY.vocab_size, (len(PADS), 12), generator=torch.Generator().manual_seed(0))
    return ids, M.mask_of_first(torch.tensor(PADS), 12)


def test_mla_on_the_cpu_never_reaches_the_kernel(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel's wrapper was called on CPU tensors")

    monkeypatch.setattr(dv, "mla_attention", refuse)
    P = dv.random_deepseek_v2_params(TINY, dtype=torch.float32, seed=3, device="cpu")
    ids, mask = _tiny_batch()
    counters = dv.DeviceCounters()
    before = M.mla_attention.launches
    out = dv.deepseek_v2_forward(P, ids, mask, TINY, counters)
    assert torch.isfinite(out).all() and M.mla_attention.launches == before
    assert not any(k.startswith("mla.") for k in counters.read())


def test_widths_without_a_kernel_are_refused_before_any_launch():
    q, kv, k_pe = _inputs(1, 4, 2, (64, 32, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel"):
        M._check(q, kv, k_pe, torch.zeros(1, dtype=torch.int32), (64, 32, 64))


# ---------------------------------------------------------------- the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False


def _held(widths, B, T, H, pads, seed):
    """The kernel against the twin (bf16) and both against fp32 on real rows;
    pad rows 0, repeats bit for bit, no host sync. Returns the gaps."""
    q, kv, k_pe = _inputs(B, T, H, widths, torch.bfloat16, "cuda", seed)
    first = torch.tensor(pads, dtype=torch.int32, device="cuda")
    mask = M.mask_of_first(first, T)
    bias = M.attention_bias(mask)
    before = M.mla_attention.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = M.mla_attention(q, kv, k_pe, first, SCALE, widths)
        again = M.mla_attention(q, kv, k_pe, first, SCALE, widths)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert M.mla_attention.launches == before + 2
    twin = M.mla_attention_plain(q, kv, k_pe, bias, SCALE, widths)
    exact = M.mla_attention_plain(q.float(), kv.float(), k_pe.float(), bias, SCALE, widths)
    assert torch.equal(got, again)
    assert torch.isfinite(got).all()
    assert (got[~mask] == 0).all()
    gaps = {"twin": _rel(got[mask], twin[mask]), "kernel_fp32": _rel(got[mask], exact[mask]),
            "twin_fp32": _rel(twin[mask], exact[mask])}
    assert gaps["twin"] < BF16_TOL, gaps
    assert gaps["kernel_fp32"] <= gaps["twin_fp32"] * 1.05, gaps
    return gaps


@pytest.mark.cuda
def test_kernel_matches_the_twin_at_the_cells_shape():
    _card()
    _held(FULL_WIDTHS, 10, 2048, 16, (0, 1, 127, 128, 129, 1500, 2047, 0, 491, 1024), seed=1)


@pytest.mark.cuda
@pytest.mark.parametrize("widths,B,T,H,pads", [(TINY_WIDTHS, 4, 12, 4, (5, 0, 11, 2)),
                                               (TINY_WIDTHS, 3, 300, 4, (0, 129, 299)),
                                               (FULL_WIDTHS, 3, 200, 2, (0, 64, 199)),
                                               (FULL_WIDTHS, 2, 128, 3, (127, 0))])
def test_kernel_matches_the_twin_at_small_and_ragged_shapes(widths, B, T, H, pads):
    _card()
    _held(widths, B, T, H, pads, seed=2)


@pytest.mark.cuda
def test_the_kernel_refuses_other_widths_on_the_card():
    _card()
    q, kv, k_pe = _inputs(1, 4, 2, (64, 32, 64), torch.bfloat16, "cuda")
    with pytest.raises(ValueError, match="no kernel"):
        M.mla_attention(q, kv, k_pe, torch.zeros(1, dtype=torch.int32, device="cuda"), SCALE, (64, 32, 64))
    with pytest.raises(TypeError):
        M.mla_attention(q.float(), kv, k_pe, torch.zeros(1, dtype=torch.int32, device="cuda"), SCALE, FULL_WIDTHS)


@pytest.mark.cuda
def test_the_encoder_on_the_card_launches_the_kernel_each_layer_and_counts_its_tiles():
    """Every layer's attention is one launch, the plain twin is never
    reached, the tile counters are the counts of the first-real index, and
    the bf16 forward stays within 3e-2 of the fp32 CPU forward on real
    tokens (test_torch_deepseek_v2.py's bar for bf16)."""
    _card()
    cfg = TINY
    P32 = dv.random_deepseek_v2_params(cfg, dtype=torch.float32, seed=3, device="cpu")

    def card(t, name):
        return t.to("cuda", torch.float32 if name == "router" else torch.bfloat16)

    P = {"embed": card(P32["embed"], "embed"), "final_ln": card(P32["final_ln"], "final_ln"),
         "layers": [{k: card(v, k) for k, v in lp.items()} for lp in P32["layers"]]}
    ids, mask = _tiny_batch()
    counters = dv.DeviceCounters()

    def refuse(*args, **kwargs):
        raise AssertionError("the plain twin ran on the card")

    twin = dv.mla_attention_plain
    dv.mla_attention_plain = refuse
    try:
        before = M.mla_attention.launches
        out = dv.deepseek_v2_forward(P, ids.cuda(), mask.cuda(), cfg, counters)
        dv.deepseek_v2_forward(P, ids.cuda(), mask.cuda(), cfg, counters)
    finally:
        dv.mla_attention_plain = twin
    assert M.mla_attention.launches - before == 2 * cfg.num_hidden_layers
    run, skipped = M.tile_counts(torch.tensor(PADS, dtype=torch.int32), 12)
    per = 2 * cfg.num_attention_heads * cfg.num_hidden_layers
    c = counters.read()
    assert (c["mla.tiles_run"], c["mla.tiles_skipped"]) == (int(run) * per, int(skipped) * per)
    want = dv.deepseek_v2_forward(P32, ids, mask, cfg)
    assert _rel(out.float().cpu()[mask], want[mask]) < 3e-2
