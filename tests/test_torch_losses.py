"""cse_tpu_torch.ops.losses against cse_tpu.ops.losses (same numpy inputs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cse_tpu.ops import losses as jl
from cse_tpu_torch.ops import losses as tl

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _sig(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("zero_mean", [True, False])
def test_si_snr(rng, zero_mean):
    pred, target = _sig(rng, 3, 4, 400), _sig(rng, 3, 4, 400)
    pred[0] = 0.7 * target[0] + 0.1 * pred[0]  # one well-separated row
    want = jl.si_snr(jnp.asarray(pred), jnp.asarray(target), zero_mean=zero_mean)
    got = tl.si_snr(torch.from_numpy(pred), torch.from_numpy(target), zero_mean=zero_mean)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_neg_si_snr_loss(rng):
    pred, target = _sig(rng, 4, 500), _sig(rng, 4, 500)
    want = jl.neg_si_snr_loss(jnp.asarray(pred), jnp.asarray(target))
    got = tl.neg_si_snr_loss(torch.from_numpy(pred), torch.from_numpy(target))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("C", [2, 3])
def test_pit_si_snr_loss(rng, C):
    tgt = _sig(rng, 5, 300, C)
    est = tgt[:, :, ::-1] + 0.3 * _sig(rng, 5, 300, C)  # best permutation is the reversal
    est[1] = _sig(rng, 300, C)
    want, want_perm = jl.pit_si_snr_loss(jnp.asarray(est), jnp.asarray(tgt), return_perm=True)
    got, got_perm = tl.pit_si_snr_loss(torch.from_numpy(est.copy()), torch.from_numpy(tgt), return_perm=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got_perm.numpy(), np.asarray(want_perm))
    assert tl.pit_si_snr_loss(torch.from_numpy(est.copy()), torch.from_numpy(tgt)).shape == (5,)


@pytest.mark.parametrize("use_ce,C", [(True, 2), (True, 3), (False, 1)])
def test_ctx_selection_loss(rng, use_ce, C):
    logits = 3 * _sig(rng, 6, C)
    labels = rng.integers(0, 2 if C == 1 else C, size=6).astype(np.int32)
    want = jl.ctx_selection_loss(jnp.asarray(logits), jnp.asarray(labels), use_ce)
    got = tl.ctx_selection_loss(torch.from_numpy(logits), torch.from_numpy(labels), use_ce)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
