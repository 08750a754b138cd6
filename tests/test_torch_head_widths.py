"""The head widths the port's attention kernels are instantiated for (4, 8,
16, 32, 64; the flash pair also 48; the kernel-parts tool 8 to 64), on the
CPU: the wrappers refuse any other width by name, every kernel source
dispatches on the one list of those widths in ``common.cuh``, and the plain
attention (the kernels' oracle on the card) matches the JAX package's
``_attention`` at each of them."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cse_tpu.ops.fused_stack import _attention as jax_attention
from cse_tpu_torch.ops import _build
from cse_tpu_torch.ops import attention as fa
from cse_tpu_torch.ops import fused_stack as fs
from cse_tpu_torch.ops import kernel_parts as kp

torch.set_num_threads(1)


@pytest.mark.parametrize("hd", [2, 12, 24, 128])
def test_check_head_width_names_the_widths(hd):
    with pytest.raises(ValueError, match="head widths 4, 8, 16, 32, 64; got"):
        fs.check_head_width(hd, "attention")


def test_check_head_width_takes_the_instantiated_widths():
    for hd in fs.HEAD_WIDTHS:
        fs.check_head_width(hd, "attention")
    for hd in fa.HEAD_WIDTHS:
        fs.check_head_width(hd, "flash attention", fa.HEAD_WIDTHS)
    with pytest.raises(ValueError, match="head widths 4, 8, 16, 32, 48, 64; got 40"):
        fs.check_head_width(40, "flash attention", fa.HEAD_WIDTHS)
    with pytest.raises(ValueError, match="head widths 8, 16, 32, 64; got 4"):  # the tool's own widths
        fs.check_head_width(4, "kp_attention", kp.HEAD_WIDTHS)


WIDTH_LISTS = {"HeadWidths": fs.HEAD_WIDTHS, "FlashHeadWidths": fa.HEAD_WIDTHS, "KpHeadWidths": kp.HEAD_WIDTHS}


# every C entry point that takes a head width, with the list it dispatches on
WIDTH_ENTRIES = [("fused_stack.cu", "cse_attention", "HeadWidths"),
                 ("fused_stack.cu", "cse_attention_info", "HeadWidths"),
                 ("fused_train.cu", "cse_attention_bwd", "HeadWidths"),
                 ("fused_train.cu", "cse_attention_bwd_info", "HeadWidths"),
                 ("kernel_parts.cu", "cse_kp_attention", "KpHeadWidths"),
                 ("kernel_parts.cu", "cse_kp_attention_info", "KpHeadWidths"),
                 ("attention.cu", "cse_flash_fwd", "FlashHeadWidths"),
                 ("attention.cu", "cse_flash_fwd_info", "FlashHeadWidths"),
                 ("attention.cu", "cse_flash_bwd", "FlashHeadWidths"),
                 ("attention.cu", "cse_flash_bwd_info", "FlashHeadWidths")]


@pytest.mark.parametrize("src, entry, widths", WIDTH_ENTRIES)
def test_sources_dispatch_the_wrappers_widths(src, entry, widths):
    """The C entry point dispatches on the head width through
    ``common.cuh::by_head_width`` and the one width list it names there, and
    that list is the one the wrapper lets through."""
    listed = re.search(rf"using {widths} = Widths<([\d, ]+)>;", (_build.CSRC / "common.cuh").read_text())
    assert tuple(int(w) for w in listed.group(1).split(",")) == WIDTH_LISTS[widths]
    body = re.search(rf"^int {entry}\(.*?^}}$", (_build.CSRC / src).read_text(), flags=re.M | re.S).group(0)
    assert f"by_head_width({widths}{{}}, " in body


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", fs.HEAD_WIDTHS)
def test_attention_plain_matches_jax_at_each_width(rng, hd, cd):
    """fp32: the same arithmetic, atol/rtol 1e-5. bf16: both round q*scale, k,
    v and p to bf16 at the same places; the summation order flips a few
    roundings -> relative L2 <= 1e-2 (the card's bf16 bar)."""
    G, L, H = 3, 13, 2
    D = H * hd
    qkv = (2 * rng.standard_normal((G * L, 3 * D))).astype(np.float32)
    jcd = jnp.float32 if cd == torch.float32 else jnp.bfloat16
    want = np.asarray(jax_attention(jnp.asarray(qkv), H, D, jnp.ones((L, L), bool), jcd, gb=G))
    got = fs.attention_plain(torch.from_numpy(qkv), L, H, cd).float().numpy()
    if cd == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-2
