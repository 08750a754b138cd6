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


@pytest.mark.parametrize("cd", DTYPES)
@pytest.mark.parametrize("epilogue", ["bias", "relu", "residual"])
@pytest.mark.parametrize("mkn", [(1, 256, 256), (300, 256, 768), (1000, 1024, 256), (77, 40, 24)])
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
    qkv = torch.randn(10, 3 * 128, device="cuda", generator=gen)
    with pytest.raises(ValueError, match="head width 32"):
        fs.attention(qkv, 5, 8, torch.float32)  # head width 16
    with pytest.raises(TypeError):
        fs.layer_norm(torch.randn(4, 256, device="cuda"), torch.ones(256, device="cuda"),
                      torch.zeros(256, device="cuda"), torch.float16)
    a = torch.randn(4, 12, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="K % 8"):
        fs.linear(a, torch.randn(12, 16, device="cuda").bfloat16(), torch.zeros(16, device="cuda"), "bias")
