"""The LayerNorm backward of the fused train step (cse_tpu_torch.ops.fused_train)
on the CPU: its plain version against cse_tpu/ops/fused_train.py::_ln_bwd
plus the residual add, the grid plan of its kernel, and the wrapper's errors.

Tolerance: fp32, max |err| / max |ref| <= 1e-4 (the same arithmetic, only the
summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cse_tpu.ops import fused_train as jft
from cse_tpu_torch.ops import fused_stack as tfs
from cse_tpu_torch.ops import fused_train as tft

torch.set_num_threads(1)
TOL = 1e-4


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def _inputs(m, d, g_dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal((m, d)) + 0.5).astype(np.float32)
    dh = rng.standard_normal((m, d)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    g = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32)).to(g_dtype)
    return x, dh, scale, g


def _reference(x, dh, scale, g):
    """cse_tpu's _ln_fwd / _ln_bwd, then g_out = g_in + dx and the four sums."""
    g_in = jnp.asarray(g.float().numpy())
    _, xhat, inv = jft._ln_fwd(jnp.asarray(x), jnp.asarray(scale), jnp.zeros_like(jnp.asarray(scale)))
    dx, dscale, dbias = jft._ln_bwd(jnp.asarray(dh), xhat, inv, jnp.asarray(scale))
    g_out = g_in + dx
    return np.asarray(g_out), np.stack([np.asarray(dscale), np.asarray(dbias), np.asarray(g_in.sum(0)),
                                        np.asarray(g_out.sum(0))])


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [256, 32, 16, 48])
@pytest.mark.parametrize("cd", [torch.bfloat16, None])
def test_plain_matches_jax_ln_bwd_with_the_residual_add(d, g_dtype, cd):
    x, dh, scale, g = _inputs(37, d, g_dtype)
    want, want_sums = _reference(x, dh, scale, g)
    out32 = torch.empty(37, d)
    o32, ocd, sums = tft.layer_norm_backward_plain(torch.from_numpy(dh), torch.from_numpy(x),
                                                   torch.from_numpy(scale), g, out32, cd)
    assert o32 is out32
    _close(o32.numpy(), want)
    _close(sums.numpy(), want_sums)
    if cd is None:
        assert ocd is None
    else:
        assert ocd.dtype == cd  # g_out rounded once: within a bf16 ulp (2^-8 relative) of the reference
        np.testing.assert_allclose(ocd.float().numpy(), want, rtol=2.0**-8, atol=1e-6)


@pytest.mark.parametrize("d", [256, 32, 16, 48])
def test_plain_in_place_into_an_fp32_g_in(d):
    """out32 may be g_in itself: the residual gradient updated in place, as
    the first layer's LN1 backward calls it."""
    x, dh, scale, g = _inputs(19, d, torch.float32, seed=3)
    want, want_sums = _reference(x, dh, scale, g)
    o32, ocd, sums = tft.layer_norm_backward_plain(torch.from_numpy(dh), torch.from_numpy(x),
                                                   torch.from_numpy(scale), g, g, None)
    assert o32 is g and ocd is None
    _close(g.numpy(), want)
    _close(sums.numpy(), want_sums)  # colsum(g_in) of the values before the update


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("m", [1, 7, 3001, 506016, 508000])
@pytest.mark.parametrize("per_sm", [1, 2, 3])
@pytest.mark.parametrize("warps", [1, 8])
def test_plan_covers_every_row_once(m, sms, per_sm, warps):
    """Warp w of the grid's W takes rows w, w + W, ...: every row exactly once,
    no warp more than rows_per_warp, and every block's partial row within the
    [blocks, 4, D] the wrapper allocates. ``warps``: the warps of a block, as
    the kernel's info entry reports them (8)."""
    plan = tft.ln_bwd_plan(m, 256, sms, per_sm, warps)
    assert 1 <= plan.blocks <= sms * per_sm and plan.partials == (plan.blocks, 4, 256)
    w = plan.blocks * warps
    rows = np.concatenate([np.arange(warp, m, w) for warp in range(w)])
    np.testing.assert_array_equal(np.sort(rows), np.arange(m))
    assert max(len(range(warp, m, w)) for warp in range(w)) == plan.rows_per_warp
    assert max(warp // warps for warp in range(w)) < plan.partials[0]
    if m >= sms * per_sm * warps:  # a persistent grid: every block the card holds
        assert plan.blocks == sms * per_sm
    else:  # no block without a row for its first warp
        assert (plan.blocks - 1) * warps < m


@pytest.mark.parametrize("shape, g_shape", [((64, 44), (64, 44)), ((64, 288), (64, 288)), ((64, 256), (63, 256)),
                                            ((64, 256), (64, 128))])
def test_wrapper_width_errors(monkeypatch, shape, g_shape):
    """The kernel takes [M, D] with D % 8 == 0 up to 256: the wrapper raises
    the same errors as before, ahead of any launch."""
    monkeypatch.setattr(tfs, "_route", lambda *t: True)  # the kernel path's checks, on CPU tensors
    monkeypatch.setattr(tft, "_ln_bwd_launch", lambda *a: pytest.fail("reached the launch"))
    x, dh, g = torch.zeros(shape), torch.zeros(shape), torch.zeros(g_shape)
    with pytest.raises(ValueError, match=r"D % 8 == 0, D <= 256"):
        tft.layer_norm_backward(dh, x, torch.ones(shape[1]), g, None, torch.bfloat16)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        tft.layer_norm_backward(torch.zeros(8, 32), torch.zeros(8, 32), torch.ones(32),
                                torch.zeros(8, 32, dtype=torch.float16))
    for d in (0, 44, 288):
        with pytest.raises(ValueError, match="D % 8 == 0"):
            tft.layer_norm_backward_info(100, d)


class _Launched(Exception):
    pass


@pytest.mark.parametrize("d", [8, 16, 48, 96])
def test_wrapper_takes_every_d_multiple_of_8(monkeypatch, d):
    """D % 8 == 0 up to 256 passes the wrapper's checks to the launch: the
    narrow kernel masks its lanes past D (the JAX suite's d_model 16 among
    them)."""
    monkeypatch.setattr(tfs, "_route", lambda *t: True)

    def launched(*a):
        raise _Launched

    monkeypatch.setattr(tft, "_ln_bwd_launch", launched)
    x = torch.zeros(64, d)
    with pytest.raises(_Launched):
        tft.layer_norm_backward(x, x, torch.ones(d), x.clone(), None, torch.bfloat16)
