"""cse_tpu_torch.ops.fused_train against cse_tpu.ops.fused_train (Pallas in
interpret mode on the CPU), at tests/test_fused_train.py's setup.

The port takes unpadded [G, L, D] sequences; the JAX kernel pads to
Lp = 128 with the padded keys masked, so its first L rows are compared.
Tolerances are the JAX suite's: 1e-4 forward, 2e-3 gradients (fp32).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cse_tpu.ops import fused_train as jft
from cse_tpu_torch.compat.jax_params import jax_params_to_state_dict, load_jax_params
from cse_tpu_torch.models.sepformer import SepformerConfig, TransformerStack
from cse_tpu_torch.ops import fused_train as tft

torch.set_num_threads(1)

D, H, FFN, NL, L, G = 32, 4, 64, 2, 24, 3
Lp = 128
W_NAMES = tft.W_NAMES
# bf16 stacks: the port and the JAX kernel round the same values to bf16, but
# their fp32 sums run in other orders, which flips some roundings; through 2
# layers, a final LN and a sin loss that is relative L2 <= 2e-2.
TOL_BF16 = 2e-2


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    w = {
        "qkv_w": rng.standard_normal((NL, D, 3 * D)) * 0.1,
        "qkv_b": rng.standard_normal((NL, 3 * D)) * 0.01,
        "out_w": rng.standard_normal((NL, D, D)) * 0.1,
        "out_b": rng.standard_normal((NL, D)) * 0.01,
        "ln1_s": np.ones((NL, D)) + 0.1 * rng.standard_normal((NL, D)),
        "ln1_b": 0.01 * rng.standard_normal((NL, D)),
        "ln2_s": np.ones((NL, D)) + 0.1 * rng.standard_normal((NL, D)),
        "ln2_b": 0.01 * rng.standard_normal((NL, D)),
        "f1_w": rng.standard_normal((NL, D, FFN)) * 0.1,
        "f1_b": 0.01 * rng.standard_normal((NL, FFN)),
        "f2_w": rng.standard_normal((NL, FFN, D)) * 0.1,
        "f2_b": 0.01 * rng.standard_normal((NL, D)),
    }
    x = rng.standard_normal((G, L, D))
    return {k: v.astype(np.float32) for k, v in w.items()}, x.astype(np.float32)


@functools.cache
def _jax_layers():
    """JAX fused_layers forward and the gradients of sum(y sin y) over the real rows."""
    w, x = _weights()
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    xp = jnp.asarray(np.pad(x, ((0, 0), (0, Lp - L), (0, 0))))
    mask = jnp.asarray((np.arange(Lp) < L)[None, :, None])

    def loss(x, w):
        y = jft.fused_layers(x, w, NL, H, L) * mask
        return jnp.sum(y * jnp.sin(y))

    y = jft.fused_layers(xp, jw, NL, H, L)
    gx, gw = jax.grad(loss, argnums=(0, 1))(xp, jw)
    return np.asarray(y), np.asarray(gx), {k: np.asarray(v) for k, v in gw.items()}


def _port_inputs(dtype=torch.float32, requires_grad=False):
    w, x = _weights()
    tw = {k: torch.from_numpy(v).to(dtype).requires_grad_(requires_grad) for k, v in w.items()}
    tx = torch.from_numpy(x).to(dtype).requires_grad_(requires_grad)
    return tx, tw


def test_plain_forward_matches_jax_fused_layers():
    y_jax, _, _ = _jax_layers()
    x, w = _port_inputs()
    got = tft.layers_forward(x, w, H, tft.PLAIN_OPS)
    assert got.shape == (G, L, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), y_jax[:, :L], rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        np.testing.assert_array_equal(tft.fused_layers(x, w, H).numpy(), got.numpy())


def test_gradients_match_jax_grad():
    _, gx_jax, gw_jax = _jax_layers()
    x, w = _port_inputs(requires_grad=True)
    y = tft.fused_layers(x, w, H)
    (y * torch.sin(y)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), gx_jax[:, :L], rtol=2e-3, atol=2e-3)
    for k in W_NAMES:
        np.testing.assert_allclose(w[k].grad.numpy(), gw_jax[k], rtol=2e-3, atol=2e-3, err_msg=k)


def test_unpadded_port_equals_padded_jax_rows():
    """The JAX kernel's padded rows carry no cotangent and their keys are
    masked: its dx on them is zero and its real rows are the port's result."""
    y_jax, gx_jax, _ = _jax_layers()
    assert np.abs(gx_jax[:, L:]).max() == 0.0
    assert np.isfinite(y_jax).all()
    x, w = _port_inputs()
    dx, _ = tft.layers_backward(x, torch.ones(G, L, D), w, H, tft.PLAIN_OPS)
    assert dx.shape == (G, L, D)


def test_plain_backward_passes_gradcheck():
    rng = np.random.default_rng(3)
    n, d, h, f, g, l = 1, 8, 2, 16, 2, 5

    def t(*s, scale=1.0, shift=0.0):
        return torch.tensor(shift + scale * rng.standard_normal(s), dtype=torch.float64, requires_grad=True)

    w = {"qkv_w": t(n, d, 3 * d, scale=0.3), "qkv_b": t(n, 3 * d, scale=0.1),
         "out_w": t(n, d, d, scale=0.3), "out_b": t(n, d, scale=0.1),
         "ln1_s": t(n, d, scale=0.1, shift=1.0), "ln1_b": t(n, d, scale=0.1),
         "ln2_s": t(n, d, scale=0.1, shift=1.0), "ln2_b": t(n, d, scale=0.1),
         "f1_w": t(n, d, f, scale=0.3), "f1_b": t(n, f, scale=0.5),
         "f2_w": t(n, f, d, scale=0.3), "f2_b": t(n, d, scale=0.1)}
    x = t(g, l, d)

    def fn(x, *ws):
        return tft.FusedLayers.apply(x, h, None, *ws)

    assert torch.autograd.gradcheck(fn, (x, *[w[k] for k in W_NAMES]), eps=1e-6, atol=1e-5)


def _stack_tree(seed=1, D=D, FFN=FFN):
    rng = np.random.default_rng(seed)

    def r(*s, scale=1.0):
        return (scale * rng.standard_normal(s)).astype(np.float32)

    tree = {"norm": {"scale": 1 + r(D, scale=0.1), "bias": r(D, scale=0.1)}}
    for j in range(NL):
        tree[f"layer_{j}"] = {
            "norm1": {"scale": 1 + r(D, scale=0.1), "bias": r(D, scale=0.1)},
            "norm2": {"scale": 1 + r(D, scale=0.1), "bias": r(D, scale=0.1)},
            "self_att": {"in_proj_kernel": r(D, 3 * D, scale=D ** -0.5), "in_proj_bias": r(3 * D, scale=0.1),
                         "out_proj_kernel": r(D, D, scale=D ** -0.5), "out_proj_bias": r(D, scale=0.1)},
            "ffn_1": {"kernel": r(D, FFN, scale=D ** -0.5), "bias": r(FFN, scale=0.1)},
            "ffn_2": {"kernel": r(FFN, D, scale=FFN ** -0.5), "bias": r(D, scale=0.1)},
        }
    return tree, r(G, L, D)


@functools.cache
def _jax_stack_train(cd_name, d=D, h=H, ffn=FFN):
    tree, x = _stack_tree(D=d, FFN=ffn)
    cd = jnp.float32 if cd_name == "fp32" else jnp.bfloat16

    def loss(tree, x):
        y = jft.fused_stack_train(x, tree, nhead=h, chunk=1, compute_dtype=cd)
        return jnp.sum(y * jnp.sin(y)), y

    (_, y), (g_tree, g_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    grads = {k: v.numpy() for k, v in jax_params_to_state_dict(g_tree).items()}
    return np.asarray(y), np.asarray(g_x), grads


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("cd_name", ["fp32", "bf16"])
def test_fused_stack_train_matches_jax(cd_name):
    y_jax, gx_jax, g_jax = _jax_stack_train(cd_name)
    tree, x = _stack_tree()
    cd = torch.float32 if cd_name == "fp32" else torch.bfloat16
    stack = load_jax_params(TransformerStack(SepformerConfig(d_model=D, nhead=H, d_ffn=FFN, num_tf_layers=NL)), tree)
    tx = torch.from_numpy(x).requires_grad_(True)
    y = tft.fused_stack_train(tx, stack, nhead=H, chunk=1, compute_dtype=cd)
    assert y.dtype == torch.float32 and y.shape == (G, L, D)
    (y * torch.sin(y)).sum().backward()
    got = {"x": tx.grad.numpy(), **{k: p.grad.numpy() for k, p in stack.named_parameters()}}
    want = {"x": gx_jax, **g_jax}
    assert set(got) == set(want)
    if cd == torch.float32:
        np.testing.assert_allclose(y.detach().numpy(), y_jax, rtol=1e-4, atol=1e-4)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=2e-3, err_msg=k)
    else:
        assert _rel_l2(y.detach().numpy(), y_jax) <= TOL_BF16
        for k in want:
            assert _rel_l2(got[k], want[k]) <= TOL_BF16, (k, _rel_l2(got[k], want[k]))


def test_fused_stack_train_matches_jax_at_head_width_4():
    """The JAX suite's widths (d_model 16, 4 heads of width 4, FFN 32), fp32,
    at the bars above: the card's kernels take head width 4 too."""
    d, h, ffn = 16, 4, 32
    y_jax, gx_jax, g_jax = _jax_stack_train("fp32", d, h, ffn)
    tree, x = _stack_tree(D=d, FFN=ffn)
    stack = load_jax_params(TransformerStack(SepformerConfig(d_model=d, nhead=h, d_ffn=ffn, num_tf_layers=NL)), tree)
    tx = torch.from_numpy(x).requires_grad_(True)
    y = tft.fused_stack_train(tx, stack, nhead=h, chunk=1, compute_dtype=torch.float32)
    (y * torch.sin(y)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), y_jax, rtol=1e-4, atol=1e-4)
    got = {"x": tx.grad.numpy(), **{k: p.grad.numpy() for k, p in stack.named_parameters()}}
    want = {"x": gx_jax, **g_jax}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=2e-3, err_msg=k)


def test_chunked_stack_matches_chunk_one_in_fp32():
    """chunk=2 keeps the residual fp32 across both layers; in fp32 that is the
    same function as chunk=1."""
    tree, x = _stack_tree()
    stack = load_jax_params(TransformerStack(SepformerConfig(d_model=D, nhead=H, d_ffn=FFN, num_tf_layers=NL)), tree)
    y1 = tft.fused_stack_train(torch.from_numpy(x), stack, nhead=H, chunk=1, compute_dtype=torch.float32)
    y2 = tft.fused_stack_train(torch.from_numpy(x), stack, nhead=H, chunk=2, compute_dtype=torch.float32)
    np.testing.assert_allclose(y1.detach().numpy(), y2.detach().numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["weight_grad", "linear_relu_grad", "layer_norm_backward", "attention_backward"])
def test_wrappers_raise_for_mixed_devices(name):
    cpu, meta = torch.zeros(64, 96), torch.zeros(64, 96, device="meta")
    calls = {
        "weight_grad": lambda: tft.weight_grad(cpu, meta),
        "linear_relu_grad": lambda: tft.linear_relu_grad(cpu, meta[:96, :32], meta[:, :32]),
        "layer_norm_backward": lambda: tft.layer_norm_backward(cpu[:, :32], meta[:, :32], cpu[0, :32], cpu[:, :32]),
        "attention_backward": lambda: tft.attention_backward(cpu, meta[:, :32], meta.reshape(2, 64, 48)[:, :, :1], 8, 1,
                                                            torch.float32),
    }
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        calls[name]()


def test_no_launch_on_the_cpu():
    tft.reset_launches()
    x, w = _port_inputs(requires_grad=True)
    y = tft.fused_layers(x, w, H)
    y.sum().backward()
    assert sum(tft.launch_counts().values()) == 0


def test_launches_per_train_stack_counts_the_calls():
    """The formula against the calls the orchestration makes (counted through
    the plain versions on the CPU), one stack of NL layers at chunk=1."""
    counts = dict.fromkeys(tft.launches_per_train_stack(NL), 0)
    names = {"ln": "layer_norm", "lin": "linear", "attn": "attention", "wgrad": "weight_grad",
             "relu_grad": "linear_relu_grad", "ln_bwd": "layer_norm_backward", "attn_bwd": "attention_backward"}

    def counting(attr, fn):
        def wrapped(*a, **k):
            counts[names[attr]] += 1
            return fn(*a, **k)
        return wrapped

    ops = type(tft.PLAIN_OPS)(**{a: counting(a, getattr(tft.PLAIN_OPS, a)) for a in names})
    x, w = _port_inputs()
    for li in range(NL):
        wl = {k: v[li : li + 1] for k, v in w.items()}
        tft.layers_forward(x, wl, H, ops)
        tft.layers_backward(x, torch.ones(G, L, D), wl, H, ops)
    assert counts == tft.launches_per_train_stack(NL)
    assert tft.launches_per_train_stack(8) == {
        "layer_norm": 32, "linear": 80, "attention": 16, "weight_grad": 32, "linear_relu_grad": 8,
        "layer_norm_backward": 16, "attention_backward": 8}


def test_attention_stats_are_row_max_and_inverse_sum():
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.standard_normal((2 * 7, 96)).astype(np.float32))
    stats = torch.empty(2, 14, 4)
    tft.fs.attention_plain(qkv, 7, 4, torch.float32, stats)
    q, k = qkv[:, :32].reshape(2, 7, 4, 8), qkv[:, 32:64].reshape(2, 7, 4, 8)
    s = torch.einsum("gqhd,gkhd->gqhk", q / math.sqrt(8), k)
    m = s.amax(-1)
    np.testing.assert_allclose(stats[0].numpy(), m.reshape(14, 4).numpy(), rtol=1e-6, atol=1e-6)
    z = torch.exp(s - m[..., None]).sum(-1)
    np.testing.assert_allclose(stats[1].numpy(), (1 / z).reshape(14, 4).numpy(), rtol=1e-6)
