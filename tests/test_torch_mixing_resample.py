"""cse_tpu_torch.ops.mixing and ops.resample against the jnp functions of
cse_tpu on the same arrays (atol 1e-5: the same fp32 arithmetic in another
summation order)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cse_tpu_torch.ops import mixing as tm
from cse_tpu_torch.ops import resample as tr

jm = importlib.import_module("cse_tpu.ops.mixing")
jr = importlib.import_module("cse_tpu.ops.resample")

torch.set_num_threads(1)
ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _same(got, want, atol=ATOL):
    got = [got] if isinstance(got, torch.Tensor) else got
    want = [want] if not isinstance(want, (tuple, list)) else want
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol)


def test_peak_normalize(rng):
    x = rng.standard_normal((3, 100)).astype(np.float32)
    x[2] = 0.0  # silence: the eps floor
    y = tm.peak_normalize(_t(x))
    _same(y, jm.peak_normalize(jnp.asarray(x)))
    np.testing.assert_allclose(np.abs(y.numpy()[:2]).max(axis=-1), 0.9, rtol=1e-5)


@pytest.mark.parametrize("ls,ln", [(4000, 4000), (4000, 2500), (2500, 4000), (0, 4000), (4000, 0)])
def test_mix_2spk(rng, ls, ln):
    T = 4096
    sig, noi = np.zeros((2, T), np.float32), np.zeros((2, T), np.float32)
    sig[:, :ls] = rng.standard_normal((2, ls))
    noi[:, :ln] = rng.standard_normal((2, ln))
    snr = np.array([3.3, -4.0], np.float32)
    lens = np.array([ls, ls], np.int32), np.array([ln, ln], np.int32)
    got = tm.mix_2spk(_t(sig), _t(noi), _t(snr), _t(lens[0]), _t(lens[1]))
    want = jm.mix_2spk(jnp.asarray(sig), jnp.asarray(noi), jnp.asarray(snr), jnp.asarray(lens[0]), jnp.asarray(lens[1]))
    _same(got, want)


def test_mix_3spk(rng):
    T = 4000
    s, n1, n2 = (rng.standard_normal((2, T)).astype(np.float32) for _ in range(3))
    n1[:, 3000:] = 0
    n2[1, 1000:] = 0
    l0, l1, l2 = np.array([T, T], np.int32), np.array([3000, 3000], np.int32), np.array([T, 1000], np.int32)
    snr1, snr2 = np.array([2.0, -3.0], np.float32), np.array([-1.0, 5.0], np.float32)
    got = tm.mix_3spk(*map(_t, (s, n1, n2, snr1, snr2, l0, l1, l2)))
    want = jm.mix_3spk(*map(jnp.asarray, (s, n1, n2, snr1, snr2, l0, l1, l2)))
    _same(got, want)
    sg, g1n = got[1].numpy(), got[2].numpy()
    # the requested SNR holds between the mean energies over each signal's own length
    assert abs(10 * np.log10(((sg[0] ** 2).sum() / T) / ((g1n[0] ** 2).sum() / 3000)) - 2.0) < 1e-3


def test_add_noise_snr(rng):
    x = rng.standard_normal((3, 3000)).astype(np.float32)
    n = rng.standard_normal((3, 3000)).astype(np.float32)
    n[2] = 0.0  # silent noise: the energy floor
    snr = np.array([5.0, 0.0, 3.0], np.float32)
    got = tm.add_noise_snr(_t(x), _t(n), _t(snr))
    _same(got, jm.add_noise_snr(jnp.asarray(x), jnp.asarray(n), jnp.asarray(snr)))
    added = got.numpy()[:2] - x[:2]
    np.testing.assert_allclose(10 * np.log10((x[:2] ** 2).sum(-1) / (added ** 2).sum(-1)), [5.0, 0.0], atol=1e-3)


def test_circular_shift_respects_length():
    x = np.array([[1.0, 2.0, 3.0, 4.0, 0.0, 0.0]], np.float32)
    y = tm.circular_shift(_t(x), _t(np.array([1], np.int32)), _t(np.array([4], np.int32)))
    np.testing.assert_allclose(y.numpy()[0], [4.0, 1.0, 2.0, 3.0, 0.0, 0.0])
    y2 = tm.circular_shift(_t(x), _t(np.array([-1], np.int32)), _t(np.array([4], np.int32)))
    np.testing.assert_allclose(y2.numpy()[0], [2.0, 3.0, 4.0, 1.0, 0.0, 0.0])


@pytest.mark.parametrize("with_lengths", [True, False])
def test_circular_shift_matches(rng, with_lengths):
    x = rng.standard_normal((4, 500)).astype(np.float32)
    lens = np.array([500, 300, 0, 7], np.int32)  # zero length; shift > length
    x *= np.arange(500)[None, :] < lens[:, None]
    shifts = np.array([37, -801, 5, 1000], np.int32)
    jl, tl = (jnp.asarray(lens), _t(lens)) if with_lengths else (None, None)
    _same(tm.circular_shift(_t(x), _t(shifts), tl), jm.circular_shift(jnp.asarray(x), jnp.asarray(shifts), jl), atol=0)


def test_filter_taps_are_bit_identical():
    for a, b, kw in ((16000, 8000, {}), (8000, 16000, {}), (14400, 16000, {}), (17600, 16000, {}),
                     (16000, 8000, dict(lowpass_filter_width=64, window="kaiser"))):
        tk, jk = tr.resample_poly_filter(a, b, **kw), jr.resample_poly_filter(a, b, **kw)
        np.testing.assert_array_equal(tk[0], jk[0])
        assert tk[1:] == jk[1:]
    assert tr.resample_poly_filter(16000, 16000)[0] is None
    with pytest.raises(ValueError, match="unknown window"):
        tr.resample_poly_filter(16000, 8000, window="boxcar")


@pytest.mark.parametrize("orig,new", [(16000, 8000), (8000, 16000), (14400, 16000), (17600, 16000), (16000, 16000)])
def test_resample_matches(rng, orig, new):
    x = rng.standard_normal((3, 6000)).astype(np.float32)
    lens = np.array([6000, 2501, 0], np.int32)
    y, nl = tr.resample(_t(x), orig, new, lengths=_t(lens))
    wy, wl = jr.resample(jnp.asarray(x), orig, new, lengths=jnp.asarray(lens))
    _same(y, wy)
    np.testing.assert_array_equal(nl.numpy(), np.asarray(wl))
    assert nl.dtype == torch.int32
    assert tr.resample(_t(x), orig, new)[1] is None


def test_resample_leading_dims_and_kaiser(rng):
    x = rng.standard_normal((2, 3, 2000)).astype(np.float32)
    y, _ = tr.resample(_t(x), 16000, 8000, lowpass_filter_width=64, window="kaiser")
    wy, _ = jr.resample(jnp.asarray(x), 16000, 8000, lowpass_filter_width=64, window="kaiser")
    _same(y, wy)


def test_downsample_sine_preserved():
    t = np.arange(16000) / 16000
    x = np.sin(2 * np.pi * 440.0 * t).astype(np.float32)[None]
    y, nl = tr.resample(_t(x), 16000, 8000, lengths=_t(np.array([16000], np.int32)))
    assert y.shape[-1] == 8000 and int(nl[0]) == 8000
    expect = np.sin(2 * np.pi * 440.0 * np.arange(8000) / 8000)
    assert np.abs(y.numpy()[0, 100:-100] - expect[100:-100]).max() < 0.02


def test_speed_perturb_matches_all_three_factors(rng):
    T = 8000
    x = rng.standard_normal((4, T)).astype(np.float32)
    lens = np.array([T, 6000, 4000, 0], np.int32)
    x *= np.arange(T)[None, :] < lens[:, None]
    idx = np.array([0, 1, 2, 0], np.int32)
    y, nl = tr.speed_perturb(_t(x), _t(lens), _t(idx))
    wy, wl = jr.speed_perturb(jnp.asarray(x), jnp.asarray(lens), jnp.asarray(idx))
    _same(y, wy)
    np.testing.assert_array_equal(nl.numpy(), np.asarray(wl))
    assert y.shape[-1] == int(np.ceil(T / 0.9))
    assert [int(v) for v in nl] == [int(np.ceil(T / 0.9)), 6000, int(np.ceil(4000 * 10 / 11)), 0]


def test_speed_identity_branch(rng):
    x = rng.standard_normal((1, 4000)).astype(np.float32)
    y, nl = tr.speed_perturb(_t(x), _t(np.array([4000], np.int32)), _t(np.array([1], np.int32)))
    np.testing.assert_allclose(y.numpy()[0, :4000], x[0], atol=1e-6)
    assert int(nl[0]) == 4000 and float(y[0, 4000:].abs().max()) == 0.0
