"""cse_tpu_torch.ops.fused_stack against the JAX fused stack (Pallas interpret
mode on the CPU) and the flax TransformerStack."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cse_tpu.models.sepformer import TransformerStack as JaxStack
from cse_tpu.models.sepformer import sinusoidal_pe as jax_pe
from cse_tpu.ops.fused_stack import fused_stack_apply as jax_fused_stack_apply
from cse_tpu_torch.compat.jax_params import load_jax_params
from cse_tpu_torch.models.sepformer import SepformerConfig, TransformerStack, sinusoidal_pe
from cse_tpu_torch.ops import fused_stack as fs

torch.set_num_threads(1)

G, L, D, H, FFN, NL = 6, 11, 16, 4, 32, 2


def _stack_params(rng, d=D, ffn=FFN, n_layers=NL):
    """A flax TransformerStack param tree with non-trivial biases and LN."""
    def n(*s, scale=1.0):
        return (scale * rng.standard_normal(s)).astype(np.float32)

    tree = {"norm": {"scale": 1 + n(d, scale=0.1), "bias": n(d, scale=0.1)}}
    for j in range(n_layers):
        tree[f"layer_{j}"] = {
            "norm1": {"scale": 1 + n(d, scale=0.1), "bias": n(d, scale=0.1)},
            "norm2": {"scale": 1 + n(d, scale=0.1), "bias": n(d, scale=0.1)},
            "self_att": {
                "in_proj_kernel": n(d, 3 * d, scale=d ** -0.5),
                "in_proj_bias": n(3 * d, scale=0.1),
                "out_proj_kernel": n(d, d, scale=d ** -0.5),
                "out_proj_bias": n(d, scale=0.1),
            },
            "ffn_1": {"kernel": n(d, ffn, scale=d ** -0.5), "bias": n(ffn, scale=0.1)},
            "ffn_2": {"kernel": n(ffn, d, scale=ffn ** -0.5), "bias": n(d, scale=0.1)},
        }
    return tree


def _port_stack(tree, d=D, h=H, ffn=FFN, n_layers=NL):
    cfg = SepformerConfig(d_model=d, nhead=h, d_ffn=ffn, num_tf_layers=n_layers)
    return load_jax_params(TransformerStack(cfg), tree)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_fp32_matches_jax_fused_stack(rng):
    tree = _stack_params(rng)
    x = rng.standard_normal((G, L, D)).astype(np.float32)
    want = np.asarray(jax_fused_stack_apply(jnp.asarray(x), tree, nhead=H, compute_dtype=jnp.float32))
    w = fs.stack_weights(_port_stack(tree), torch.float32)
    got = fs.fused_stack_apply(torch.from_numpy(x), w, nhead=H, compute_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (G, L, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_bf16_matches_jax_fused_stack(rng):
    """bf16 compute: both sides round the same values (input, weights, biases,
    LN params, matmul operands, q*scale, p) to bf16; fp32 accumulation order
    differs and flips a few roundings -> relative L2 <= 1e-2 (the tolerance
    the card's check uses). Output dtype follows the fp32 input."""
    tree = _stack_params(rng)
    x = rng.standard_normal((G, L, D)).astype(np.float32)
    want = np.asarray(jax_fused_stack_apply(jnp.asarray(x), tree, nhead=H, compute_dtype=jnp.bfloat16))
    w = fs.stack_weights(_port_stack(tree), torch.bfloat16)
    got = fs.fused_stack_apply(torch.from_numpy(x), w, nhead=H, compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    assert _rel_l2(got.numpy(), want) <= 1e-2
    # bf16 in -> bf16 out, same values as rounding the fp32-in result's input
    got16 = fs.fused_stack_apply(torch.from_numpy(x).bfloat16(), w, nhead=H, compute_dtype=torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    assert _rel_l2(got16.float().numpy(), want) <= 1e-2


def test_full_width_matches_flax_stack(rng):
    """Paper width (D 256, 8 heads, FFN 1024, 8 layers) at tiny G, L against
    flax TransformerStack.apply, which adds the PE itself."""
    d, h, ffn, nl, g, l = 256, 8, 1024, 8, 2, 5
    tree = _stack_params(rng, d, ffn, nl)
    x = rng.standard_normal((g, l, d)).astype(np.float32)
    want = np.asarray(JaxStack(nl, d, h, ffn).apply({"params": tree}, jnp.asarray(x)))
    w = fs.stack_weights(_port_stack(tree, d, h, ffn, nl), torch.float32)
    xt = torch.from_numpy(x) + sinusoidal_pe(l, d)[None]
    got = fs.fused_stack_apply(xt, w, nhead=h, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_sinusoidal_pe_matches():
    """Arguments reach ~300 rad, where one fp32 ulp of the argument (and of
    the exp that scales it, which differs by a ulp between libms) is ~3e-5:
    atol 5e-5."""
    np.testing.assert_allclose(
        sinusoidal_pe(300, 256).numpy(), np.asarray(jax_pe(2500, 256))[:300], rtol=0, atol=5e-5
    )


@pytest.mark.parametrize("seq_len", [1, 7, 33])
def test_attention_plain_groups_match_one_shot(rng, seq_len):
    """attention_plain processes sequences in groups; the grouping must not
    change the result (checked against a direct softmax attention)."""
    g, h, hd = 5, 2, 8
    qkv = torch.from_numpy(rng.standard_normal((g * seq_len, 3 * h * hd)).astype(np.float32))
    got = fs.attention_plain(qkv, seq_len, h, torch.float32)
    q, k, v = qkv.reshape(g, seq_len, 3, h, hd).permute(2, 0, 3, 1, 4)
    p = torch.softmax(q @ k.transpose(-1, -2) / hd ** 0.5, dim=-1)
    want = (p @ v).transpose(1, 2).reshape(g * seq_len, h * hd)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_cpu_path_launches_no_kernel(rng):
    tree = _stack_params(rng)
    w = fs.stack_weights(_port_stack(tree), torch.float32)
    fs.reset_launches()
    x = torch.from_numpy(rng.standard_normal((G, L, D)).astype(np.float32))
    x0 = x.clone()
    fs.fused_stack_apply(x, w, nhead=H, compute_dtype=torch.float32)
    assert fs.launch_counts() == {"layer_norm": 0, "linear": 0, "attention": 0}
    assert torch.equal(x, x0)  # the residual updates in place on a copy
    assert fs.launches_per_stack(8) == {"layer_norm": 17, "linear": 32, "attention": 8}


def test_wrappers_refuse_other_devices():
    x = torch.empty(4, 16, device="meta")
    s = torch.empty(16, device="meta")
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        fs.layer_norm(x, s, s, torch.float32)
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        fs.attention(torch.empty(4, 48, device="meta"), 4, 2, torch.float32)
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        fs.linear(x, torch.empty(16, 8), torch.empty(8), "bias")
