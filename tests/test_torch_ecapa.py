"""The port's speaker encoders against cse_tpu's on the CPU: the ECAPA-TDNN
(``cse_tpu_torch/models/ecapa.py``; the fbank at rtol 1e-4 / atol 1e-3, the
embedding at rtol 1e-3 / atol 1e-4, the bars of tests/test_ecapa.py) on
``random_ecapa_params`` carried by ``compat.jax_params.ecapa_state_dict_from_jax``
(BatchNorm off its identity, so its carry counts), speechbrain's key layout
both ways, the padding invariance of the masked statistics, and the spectral
stand-in (``models/speaker_encoder.py``) with JAX's projection carried across
(1e-5). ECAPA at 64 channels, 16-d."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cse_tpu.models import ecapa as jecapa
from cse_tpu.models import speaker_encoder as jspeaker
from cse_tpu_torch.compat.jax_params import ecapa_state_dict_from_jax, spectral_projection_from_jax
from cse_tpu_torch.models import ecapa
from cse_tpu_torch.models.speaker_encoder import (
    SpectralSpeakerEncoder,
    build_speaker_encoder,
    encode_speaker,
)

torch.set_num_threads(1)

C, EMB = 64, 16
LENGTHS = np.array([12000, 7000, 2500], np.int32)  # a full, a partial and a short row


def _lengths(with_lengths):
    return LENGTHS if with_lengths else None


@pytest.fixture(scope="module")
def jax_params():
    """``random_ecapa_params`` with every BatchNorm given random statistics and affine."""
    rng = np.random.default_rng(1)

    def visit(node):
        if isinstance(node, dict):
            if set(node) == {"scale", "bias", "mean", "var"}:
                c = node["scale"].shape[0]
                return {"scale": (rng.random(c) + 0.5).astype(np.float32),
                        "bias": (rng.standard_normal(c) * 0.1).astype(np.float32),
                        "mean": (rng.standard_normal(c) * 0.2).astype(np.float32),
                        "var": (rng.random(c) * 0.5 + 0.5).astype(np.float32)}
            return {k: visit(v) for k, v in node.items()}
        return node

    return visit(jecapa.random_ecapa_params(None, channels=C, emb=EMB))


@pytest.fixture(scope="module")
def wav():
    x = (np.random.default_rng(0).standard_normal((3, 12000)) * 0.3).astype(np.float32)
    x[np.arange(12000)[None, :] >= LENGTHS[:, None]] = 0.0
    return x


def _port_module(params):
    m = ecapa.EcapaTDNN(channels=C, emb=EMB)
    m.load_state_dict(ecapa_state_dict_from_jax(params), strict=True)
    return m.eval()


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


@pytest.mark.parametrize("with_lengths", [False, True])
def test_fbank_matches_jax(wav, with_lengths):
    lengths = _lengths(with_lengths)
    want = np.asarray(jecapa.log_mel_fbank(jnp.asarray(wav), lengths=None if lengths is None else jnp.asarray(lengths)))
    got = ecapa.log_mel_fbank(torch.from_numpy(wav), lengths=_t(lengths)).numpy()
    assert got.shape == want.shape == (3, 1 + 12000 // 160, 80)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("with_lengths", [False, True])
def test_embedding_matches_jax(jax_params, wav, with_lengths):
    lengths = _lengths(with_lengths)
    want = np.asarray(jecapa.ecapa_forward(jax.tree.map(jnp.asarray, jax_params), jnp.asarray(wav),
                                           None if lengths is None else jnp.asarray(lengths)))
    enc = ecapa.EcapaEncoder(module=_port_module(jax_params), device="cpu")
    got = enc(torch.from_numpy(wav), _t(lengths))
    assert got.shape == (3, 1, EMB) and not got.requires_grad
    np.testing.assert_allclose(got[:, 0].numpy(), want, rtol=1e-3, atol=1e-4)


def test_state_dict_has_speechbrains_layout_both_ways(tmp_path, jax_params, wav):
    """A state dict saved from the port's module is read by cse_tpu's
    speechbrain importer (``ecapa_from_state_dict``) into the same function,
    and ``EcapaEncoder`` loads the saved ``.ckpt`` strictly."""
    gen = torch.Generator().manual_seed(3)
    module = ecapa.EcapaTDNN(channels=C, emb=EMB, generator=gen).eval()
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.copy_(0.2 * torch.randn(m.num_features, generator=gen))
                m.running_var.copy_(0.5 + 0.5 * torch.rand(m.num_features, generator=gen))
    path = str(tmp_path / "embedding_model.ckpt")
    torch.save(module.state_dict(), path)
    assert {k.split(".")[0] for k in module.state_dict()} == {"blocks", "mfa", "asp", "asp_bn", "fc"}
    sd = {k: v.numpy() for k, v in torch.load(path, weights_only=True).items()}
    jparams = jax.tree.map(jnp.asarray, jecapa.ecapa_from_state_dict(sd))
    lengths = jnp.asarray(LENGTHS)
    want = np.asarray(jecapa.ecapa_forward(jparams, jnp.asarray(wav), lengths))
    got = ecapa.EcapaEncoder(path, device="cpu")(wav, LENGTHS)[:, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    # and back: the JAX tree carried to the port gives the saved module's entries
    back = ecapa_state_dict_from_jax(jax.tree.map(np.asarray, jparams))
    assert set(back) == set(module.state_dict())
    for k, v in module.state_dict().items():
        assert torch.equal(back[k], v), k


def test_length_masking_padding_invariance(jax_params):
    """With lengths, an utterance's embedding hardly depends on its trailing
    zero padding (the pooled statistics are masked; the convolutions still
    see the pad, as in speechbrain); without them, it does."""
    m = _port_module(jax_params)
    n = 48000  # 3 s enrollment in the 5 s crop buffer (the train shape)
    x = (np.random.default_rng(0).standard_normal(n) * 0.3).astype(np.float32)
    short = torch.from_numpy(x[None])
    padded = torch.from_numpy(np.pad(x, (0, 80000 - n))[None])
    with torch.no_grad():
        e_ref = m(short, torch.tensor([n]))[0]
        e_mask = m(padded, torch.tensor([n]))[0]
        e_nomask = m(padded)[0]
    cos = torch.nn.functional.cosine_similarity
    d_masked, d_unmasked = (e_mask - e_ref).norm(), (e_nomask - e_ref).norm()
    assert cos(e_mask, e_ref, dim=0) > cos(e_nomask, e_ref, dim=0)
    assert d_masked < 0.1 * d_unmasked, (d_masked, d_unmasked)


@pytest.mark.parametrize("with_lengths", [False, True])
def test_stand_in_matches_jax(wav, with_lengths):
    lengths = _lengths(with_lengths)
    want = np.asarray(jspeaker._spectral_embedding(jnp.asarray(wav), None if lengths is None else jnp.asarray(lengths)))
    proj = spectral_projection_from_jax(np.asarray(jax.random.normal(jax.random.key(0), (402, 192))))
    got = encode_speaker(SpectralSpeakerEncoder(projection=proj), torch.from_numpy(wav), _t(lengths))
    assert got.shape == want.shape == (3, 1, 192)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_build_speaker_encoder_picks_real_or_stand_in(tmp_path, monkeypatch, capsys):
    stand = build_speaker_encoder("", "cpu")
    assert stand.is_stub and "SpectralSpeakerEncoder" in capsys.readouterr().err
    assert torch.equal(stand.W, SpectralSpeakerEncoder(seed=0).W)  # drawn from the seeded generator
    path = str(tmp_path / "embedding_model.ckpt")
    torch.save(ecapa.EcapaTDNN(channels=C, emb=EMB).state_dict(), path)
    real = build_speaker_encoder(path, "cpu")
    assert not real.is_stub and real.device.type == "cpu"
    assert real(torch.zeros(1, 8000), torch.tensor([8000])).shape == (1, 1, EMB)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_speaker_encoder(path)  # the card by default: no CPU fallback
