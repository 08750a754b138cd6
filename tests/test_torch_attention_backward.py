"""The oracles of the training backward's two largest kernels, on the CPU.

``ops.fused_train.attention_backward_plain`` is what the attention backward
kernels (the bf16 one-pass strip for L <= 256 and the two-kernel route
beyond) are held against on the card. Here it is held against autograd
through ``ops.fused_stack.attention_plain`` in float64, where the only
difference is the order of the sums (so rtol 1e-6 of the largest entry), and
against the JAX package's ``_bwd_kernel`` (Pallas in interpret mode) at one
small shape, at tests/test_torch_fused_train.py's fp32 gradient bar (2e-3).
``wgrad_plan`` sizes the weight gradient's slabs of rows: every row must
fall in exactly one slab, each a whole number of the bf16 kernel's 64-row
chunks.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cse_tpu.ops import fused_train as jft
from cse_tpu_torch.ops import _build
from cse_tpu_torch.ops import fused_stack as fs
from cse_tpu_torch.ops import fused_train as ft

torch.set_num_threads(1)


def _inputs(seq_len, H, hd, G=2, seed=0):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(2 * rng.standard_normal((G * seq_len, 3 * H * hd)))
    dattn = torch.from_numpy(rng.standard_normal((G * seq_len, H * hd)))
    return qkv, dattn


@pytest.mark.parametrize("seq_len", [7, 127, 251, 256, 300])
@pytest.mark.parametrize("hd", [8, 16, 32, 64])
def test_oracle_is_the_gradient_of_the_attention(hd, seq_len):
    H = 2
    qkv, dattn = _inputs(seq_len, H, hd)
    stats = torch.empty(2, qkv.shape[0], H, dtype=torch.float64)
    x = qkv.clone().requires_grad_(True)
    (fs.attention_plain(x, seq_len, H, torch.float64, stats) * dattn).sum().backward()
    dqkv, dbias = ft.attention_backward_plain(qkv, dattn, stats.detach(), seq_len, H, torch.float64)
    want = x.grad.numpy()
    assert dqkv.dtype == torch.float64 and dqkv.shape == qkv.shape
    np.testing.assert_allclose(dqkv.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(dbias.numpy(), want.sum(axis=0), rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_oracle_matches_the_jax_backward_kernel():
    """One pre-LN layer (d_model 32, 4 heads of width 8, L 24, 3 sequences)
    through cse_tpu's fused_layers (_bwd_kernel in interpret mode, padded to
    128 rows with the padded keys masked) and through the port's plain ops:
    the qkv weight and bias gradients are the attention backward's dqkv
    carried through one product and one column sum."""
    D, H, FFN, L, G = 32, 4, 64, 24, 3
    rng = np.random.default_rng(5)
    shapes = {"qkv_w": (D, 3 * D), "qkv_b": (3 * D,), "out_w": (D, D), "out_b": (D,), "ln1_s": (D,),
              "ln1_b": (D,), "ln2_s": (D,), "ln2_b": (D,), "f1_w": (D, FFN), "f1_b": (FFN,), "f2_w": (FFN, D),
              "f2_b": (D,)}
    w = {k: (1.0 if k.endswith("_s") else 0.0) + (0.1 if len(s) == 2 else 0.01) * rng.standard_normal((1, *s))
         for k, s in shapes.items()}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = rng.standard_normal((G, L, D)).astype(np.float32)
    gy = rng.standard_normal((G, L, D)).astype(np.float32)
    Lp = 128
    xp = jnp.asarray(np.pad(x, ((0, 0), (0, Lp - L), (0, 0))))
    gp = jnp.asarray(np.pad(gy, ((0, 0), (0, Lp - L), (0, 0))))
    _, vjp = jax.vjp(lambda w_: jft.fused_layers(xp, w_, 1, H, L), {k: jnp.asarray(v) for k, v in w.items()})
    (jw,) = vjp(gp)
    _, tw = ft.layers_backward(torch.from_numpy(x), torch.from_numpy(gy), {k: torch.from_numpy(v) for k, v in w.items()},
                               H, ft.PLAIN_OPS)
    for k in ("qkv_w", "qkv_b"):
        got, want = tw[k].numpy(), np.asarray(jw[k])
        if k == "qkv_b":  # the key bias's gradient is rounding noise: compare q and v
            got, want = ft.qv_part(torch.from_numpy(got)).numpy(), ft.qv_part(torch.from_numpy(want)).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3, err_msg=k)


def test_strip_bound_matches_the_source():
    """The wrapper sizes the partials by the route the C launcher takes."""
    text = (_build.CSRC / "fused_train.cu").read_text()
    assert f"constexpr int STRIP_MAX_L = {ft.BWD_STRIP_MAX_L};" in text


# the main path's weight gradients (intra and inter rows at B=16; qkv, out,
# FFN1, FFN2), the tiny model's (16 s: 2564 x 50 = 100 x 1282 rows) and a ragged few rows
WGRAD_CASES = [(m, k, n) for m in (506016, 508000) for k, n in ((256, 768), (256, 256), (256, 1024), (1024, 256))]
WGRAD_CASES += [(m, k, n) for m in (128200, 1001) for k, n in ((32, 96), (32, 32), (32, 64), (64, 32))]


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("mkn", WGRAD_CASES)
def test_wgrad_plan_covers_every_row_once(mkn, bf16):
    M, K, N = mkn
    slab, slabs = ft.wgrad_plan(M, K, N, bf16, sms=132)
    cover = np.zeros(M, dtype=np.int32)
    for s in range(slabs):
        cover[s * slab : (s + 1) * slab] += 1
    assert (cover == 1).all() and slabs * slab >= M
    if bf16:
        assert slab % 64 == 0
        tiles = math.ceil(K / 128) * math.ceil(N / (256 if N > 128 else 128))
        # a unit for every SM of the persistent grid, where there are rows enough
        assert tiles * slabs >= min(132, tiles * math.ceil(M / 64))
