"""The port's Whisper (``cse_tpu_torch/models/whisper.py``) against cse_tpu's
on the CPU, at the cascade's stub widths with the real vocabulary and the
30 s window (``n_audio_state`` 64, 4 heads, 2 + 2 layers), on the same
weights: the shared numpy draw of ``random_whisper_params`` or JAX's tree
carried by ``compat.jax_params.whisper_state_dict_from_jax``.

Tolerances: the mel filterbank 1e-7; the log-mel 1e-5 (inputs shorter and
longer than 30 s); the encoder and each KV-cached decoder step (with and
without a previous-text offset) 1e-4 of the largest magnitude; decoding,
greedy and timestamped, with and without a previous-text prompt, at any
host-sync period: tokens and lengths equal, ``sum_logprob`` 1e-4,
``no_speech_prob`` 1e-5; a sampled rung fed JAX's Gumbel draws: tokens
equal; language detection equal; the policy functions on
tests/test_whisper.py's cases equal; ``transcribe_results`` over a 37 s
input (the seek loop, language detected) equal; a fabricated OpenAI
``base.pt`` loads strictly and matches JAX's ``whisper_from_state_dict``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cse_tpu.models import whisper as jw
from cse_tpu_torch.compat.jax_params import whisper_state_dict_from_jax
from cse_tpu_torch.models import whisper as tw

torch.set_num_threads(1)

JCFG = jw.WhisperConfig(n_audio_state=64, n_audio_head=4, n_audio_layer=2,
                        n_text_state=64, n_text_head=4, n_text_layer=2)
TCFG = tw.WhisperConfig(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(JCFG)})
B, MAX_TOKENS, WINDOW = 2, 32, 480000


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(x):
    return torch.from_numpy(np.array(x))


def _port(params) -> tw.Whisper:
    return tw.whisper_from_state_dict(whisper_state_dict_from_jax(params), TCFG, device="cpu")


def _peaked(win_token, seed=0, weight=10.0):
    """cse_tpu's ``_peaked_params``: final-LN scale 0 and a dominant
    embedding row, so every step emits ``win_token`` (tests/test_whisper.py);
    a small ``weight`` leaves it the argmax at a log-probability well below 0."""
    params = jw.random_whisper_params(JCFG, seed)
    b = np.linspace(0.5, 1.5, JCFG.n_text_state).astype(np.float32)
    params["dec_ln"] = {"scale": np.zeros(JCFG.n_text_state, np.float32), "bias": b}
    params["tok_emb"] = params["tok_emb"] * 0.001
    params["tok_emb"][win_token] = weight * b
    return params


@pytest.fixture(scope="module")
def params():
    return jw.random_whisper_params(JCFG, seed=3)


@pytest.fixture(scope="module")
def model(params):
    return _port(params)


@pytest.fixture(scope="module")
def wav():
    return (np.random.default_rng(0).standard_normal((B, WINDOW)) * 0.2).astype(np.float32)


@pytest.fixture(scope="module")
def mel(wav):
    return np.asarray(jw.whisper_log_mel(jnp.asarray(wav)))


@pytest.fixture(scope="module")
def audio(params, mel):
    return np.asarray(jw.whisper_encode_jit(jax.tree.map(jnp.asarray, params), jnp.asarray(mel), JCFG))


def _lang(n=B):
    return jnp.full((n,), JCFG.token_lang_en, jnp.int32), torch.full((n,), TCFG.token_lang_en)


def test_random_params_are_the_same_draws_and_round_trip(params):
    """Both packages' random Whisper of one seed is one function, and the
    carry is JAX's importer run backwards."""
    ours = tw.random_whisper_params(TCFG, seed=3)
    carried = whisper_state_dict_from_jax(params)
    assert ours.keys() == carried.keys()
    assert all(torch.equal(ours[k], carried[k]) for k in ours)
    back = jw.whisper_from_state_dict({k: v.numpy() for k, v in ours.items()}, JCFG)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back), jax.tree_util.tree_leaves_with_path(params)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_encoder_positional_buffer_is_the_sinusoid_table(model):
    buf = model.state_dict()["encoder.positional_embedding"]
    np.testing.assert_array_equal(buf.numpy(), jw._sinusoids(JCFG.n_audio_ctx, JCFG.n_audio_state))
    assert "encoder.positional_embedding" in tw.Whisper(TCFG).state_dict()


def test_mel_filters_match_jax():
    np.testing.assert_allclose(tw.mel_filters_slaney(80, 400, 16000), jw.mel_filters_slaney(80, 400, 16000),
                               atol=1e-7)


@pytest.mark.parametrize("seconds", [3.0, 30.0, 35.0])
def test_log_mel_matches_jax(seconds):
    """Padded (3 s), exact (30 s) and trimmed (35 s) inputs."""
    x = (np.random.default_rng(1).standard_normal((B, int(16000 * seconds))) * 0.3).astype(np.float32)
    want = np.asarray(jw.whisper_log_mel(jnp.asarray(x)))
    got = tw.whisper_log_mel(_t(x)).numpy()
    assert got.shape == want.shape == (B, 3000, 80)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_encoder_matches_jax(model, mel, audio):
    got = tw.whisper_encode(model, _t(mel)).numpy()
    assert got.shape == (B, 1500, 64)
    assert _rel(got, audio) <= 1e-4


@pytest.mark.parametrize("with_offset", [False, True])
def test_decoder_step_matches_jax(params, model, audio, with_offset):
    """The KV-cached step, position by position; with a previous-text offset
    the rows start at slots 3 and 5 (their pad slots masked)."""
    jp = jax.tree.map(jnp.asarray, params)
    step = jax.jit(jw._decoder_step, static_argnums=1)
    jkv = {k: jnp.zeros((2, B, JCFG.n_text_ctx, 64)) for k in ("k", "v")}
    jakv = jw._cross_kv(jp, jnp.asarray(audio), JCFG)
    tkv = tw.new_kv_cache(model, B, "cpu")
    takv = tw._cross_kv(model, _t(audio))
    offset = np.array([3, 5]) if with_offset else None
    toks = np.array([[50361, 50258, 7, 50259, 99, 4242, 17, 50364],
                     [50258, 50259, 50359, 50363, 5, 17, 0, 51000]])
    for pos in range(toks.shape[1]):
        want, jkv = step(jp, JCFG, jnp.asarray(toks[:, pos]), jnp.asarray(pos), jkv, jakv,
                         None if offset is None else jnp.asarray(offset))
        got = tw._decoder_step(model, _t(toks[:, pos]), pos, tkv, takv, None if offset is None else _t(offset))
        assert _rel(got.numpy(), want) <= 1e-4, pos


def _check_decode(got, want):
    toks, lens, slp, nsp = (x.numpy() for x in got)
    np.testing.assert_array_equal(toks, np.asarray(want[0]))
    np.testing.assert_array_equal(lens, np.asarray(want[1]))
    np.testing.assert_allclose(slp, np.asarray(want[2]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(nsp, np.asarray(want[3]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("timestamps", [False, True])
@pytest.mark.parametrize("sync_every", [1, 8])
def test_decode_matches_jax(params, model, audio, timestamps, sync_every):
    """Greedy, <|notimestamps|> and timestamped (the rules each step)."""
    jl, tl = _lang()
    want = jw.whisper_decode_audio(jax.tree.map(jnp.asarray, params), jnp.asarray(audio), JCFG, jl,
                                   jnp.asarray(0.0), jax.random.PRNGKey(0), max_tokens=MAX_TOKENS,
                                   timestamps=timestamps)
    got = tw.whisper_decode_audio(model, _t(audio), tl, 0.0, max_tokens=MAX_TOKENS, timestamps=timestamps,
                                  sync_every=sync_every)
    _check_decode(got, want)


@pytest.mark.parametrize("sync_every", [1, 3, 8])
def test_decode_stopping_early_matches_jax(audio, sync_every):
    """Weights whose every step ends in EOT: SuppressBlank bars it once, so
    each row stops after one token; the host reads ``done`` every
    ``sync_every`` steps and the results equal JAX's ``while_loop`` at any
    period. EOT wins at a log-probability near -7, which ``sum_logprob``
    counts."""
    params = _peaked(JCFG.eot, seed=0, weight=0.05)
    jl, tl = _lang()
    want = jw.whisper_decode_audio(jax.tree.map(jnp.asarray, params), jnp.asarray(audio), JCFG, jl,
                                   jnp.asarray(0.0), jax.random.PRNGKey(0), max_tokens=MAX_TOKENS)
    got = tw.whisper_decode_audio(_port(params), _t(audio), tl, 0.0, max_tokens=MAX_TOKENS, sync_every=sync_every)
    assert (got[1] == 1).all() and (got[2] < -5).all()
    _check_decode(got, want)


def test_conditioned_decode_matches_jax(params, model, audio):
    """A previous-text prompt (budget 8): a row with previous text and a row without."""
    K = 8
    pt = np.zeros((B, K), np.int32)
    prev = [4242, 911, 17, 50412, 29000]
    pt[1, K - len(prev):] = prev
    pl = np.array([0, len(prev)], np.int32)
    jl, tl = _lang()
    want = jw.whisper_decode_audio(jax.tree.map(jnp.asarray, params), jnp.asarray(audio), JCFG, jl,
                                   jnp.asarray(0.0), jax.random.PRNGKey(0), max_tokens=MAX_TOKENS, timestamps=True,
                                   prev_budget=K, prev_tokens=jnp.asarray(pt), prev_lens=jnp.asarray(pl))
    got = tw.whisper_decode_audio(model, _t(audio), tl, 0.0, max_tokens=MAX_TOKENS, timestamps=True,
                                  prev_budget=K, prev_tokens=_t(pt), prev_lens=_t(pl))
    _check_decode(got, want)


@pytest.mark.parametrize("temperature", [0.4, 1.0])
def test_sampled_rung_on_jax_noise_matches_jax(params, model, audio, temperature):
    """``jax.random.categorical`` is argmax(logits / T + Gumbel); fed JAX's
    own draws (``fold_in(key, step)``) the port samples the same tokens."""
    key = jax.random.PRNGKey(3 * 1000 + 2)
    jl, tl = _lang()
    want = jw.whisper_decode_audio(jax.tree.map(jnp.asarray, params), jnp.asarray(audio), JCFG, jl,
                                   jnp.asarray(temperature), key, max_tokens=MAX_TOKENS, timestamps=True)

    def noise(step, shape):
        return _t(jax.random.gumbel(jax.random.fold_in(key, step), shape, jnp.float32))

    got = tw.whisper_decode_audio(model, _t(audio), tl, temperature, max_tokens=MAX_TOKENS, timestamps=True,
                                  noise=noise)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # the default noise is the port's own generator: a sampled rung, not greedy
    own = tw.whisper_decode_audio(model, _t(audio), tl, temperature, seed=7, max_tokens=MAX_TOKENS, timestamps=True)
    again = tw.whisper_decode_audio(model, _t(audio), tl, temperature, seed=7, max_tokens=MAX_TOKENS, timestamps=True)
    assert torch.equal(own[0], again[0])


@pytest.mark.parametrize("peaked", [False, True])
def test_detect_language_matches_jax(mel, audio, peaked):
    """Random weights, and weights whose winner is the 12th language."""
    params = _peaked(JCFG.token_lang_en + 11) if peaked else jw.random_whisper_params(JCFG, seed=3)
    jlang, jprobs = jw.whisper_detect_language_audio(jax.tree.map(jnp.asarray, params), jnp.asarray(audio), JCFG)
    lang, probs = tw.whisper_detect_language_audio(_port(params), _t(audio))
    np.testing.assert_array_equal(lang.numpy(), np.asarray(jlang))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-5)
    if peaked:
        assert (lang.numpy() == JCFG.token_lang_en + 11).all()


def test_policy_gates_match_jax():
    """``needs_fallback``, ``is_silent`` and ``compression_ratio`` on the
    grid straddling every threshold (tests/test_whisper.py's)."""
    for lp in (-3.0, -1.01, -1.0, -0.99, -0.2):
        for cr in (1.0, 2.39, 2.4, 2.41, 9.0):
            for ns in (0.0, 0.59, 0.6, 0.61, 0.99):
                assert tw.needs_fallback(lp, cr, ns) == jw.needs_fallback(lp, cr, ns)
                assert tw.is_silent(lp, ns) == jw.is_silent(lp, ns)
    for text in ("", "hello there", "w1 w1 w1 w1 w1 w1 w1 w1 w1 w1 w1 w1", "héllo ♪♪"):
        assert tw.compression_ratio(text) == jw.compression_ratio(text)
    assert tw.TRANSCRIBE_TEMPERATURES == jw.TRANSCRIBE_TEMPERATURES and tw.BEST_OF == jw.BEST_OF == 1
    assert tw._N_LANGUAGES == jw._N_LANGUAGES and tw.MAX_INITIAL_TIMESTAMP_INDEX == jw.MAX_INITIAL_TIMESTAMP_INDEX


def _seek_cases(rng):
    """tests/test_whisper.py's seek cases: every branch, then 40 random grammar-valid sequences."""
    tb = JCFG.timestamp_begin

    def ts(k):
        return tb + k

    cases = [
        [ts(5), 11, ts(40), ts(40), 12, 13, ts(90)],
        [ts(5), 11, ts(40), ts(40), 12, ts(90), ts(90)],
        [ts(5), 11, 12],
        [ts(0), 11],
        [ts(5), 11, ts(40), ts(41), 12, ts(90), ts(92)],
    ]
    for _ in range(40):
        seq, k, open_seg = [], int(rng.integers(0, 30)), False
        seq.append(ts(k))
        while len(seq) < int(rng.integers(2, 14)):
            if open_seg and rng.random() < 0.4:
                seq += [ts(k), ts(k + int(rng.integers(1, 9)))]
                k = seq[-1] - tb
                open_seg = False
            else:
                seq.append(int(rng.integers(2, 1000)))
                open_seg = True
        if rng.random() < 0.3:
            seq.append(ts(k + 1))
        cases.append(seq)
    return cases


def test_parse_seek_window_matches_jax():
    for seq in _seek_cases(np.random.default_rng(0)):
        for seek0, size, silent in ((0, 3000, False), (1234, 1766, False), (0, 3000, True)):
            adv, segs = tw.parse_seek_window(seq, silent, seek0, size, TCFG)
            want_adv, want = jw.parse_seek_window(seq, silent, seek0, size, JCFG)
            assert adv == want_adv and len(segs) == len(want), seq
            for s, w in zip(segs, want):
                np.testing.assert_array_equal(s["tokens"], w["tokens"])
                assert (s["start"], s["end"]) == (w["start"], w["end"])


def _compare_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
        for k in ("temperature", "silent", "text", "compression_ratio"):
            assert g[k] == w[k], k
        np.testing.assert_allclose(g["avg_logprob"], w["avg_logprob"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g["no_speech_prob"], w["no_speech_prob"], rtol=1e-5, atol=1e-5)
        assert [x["seek"] for x in g["windows"]] == [x["seek"] for x in w["windows"]]
        for gw, ww in zip(g["windows"], w["windows"]):
            np.testing.assert_array_equal(gw["decoded_tokens"], ww["decoded_tokens"])
        assert len(g["segments"]) == len(w["segments"])
        for gs, ws in zip(g["segments"], w["segments"]):
            np.testing.assert_array_equal(gs["tokens"], ws["tokens"])
            assert (gs["start"], gs["end"]) == (ws["start"], ws["end"])


def test_transcribe_results_seek_loop_matches_jax(params, model):
    """37 s rows: the long-form seek loop (a second window, previous-text
    prompts once a window has segments), the language detected once, the
    greedy rung, timestamped decoding."""
    x = (np.random.default_rng(2).standard_normal((B, 16000 * 37)) * 0.2).astype(np.float32)
    x[1, 16000 * 35:] = 0.0
    kw = dict(temperatures=(0.0,), language=None)
    want = jw.WhisperASR(params=params, cfg=JCFG, **kw).transcribe_results(jnp.asarray(x), max_tokens=MAX_TOKENS)
    got = tw.WhisperASR(model=model, device="cpu", **kw).transcribe_results(_t(x), max_tokens=MAX_TOKENS)
    assert all(len(r["windows"]) >= 2 for r in got)
    _compare_results(got, want)


def test_fallback_and_silence_follow_the_policy(wav):
    """The ladder (the port's own noise on the sampled rungs): a repetition
    loop escalates past greedy; a <|nospeech|> winner is silent at t=0 with
    no retry; an empty input is one silent, windowless result."""
    asr = tw.WhisperASR(model=_port(_peaked(1234)), device="cpu")
    res = asr.transcribe_results(_t(wav[:1]), max_tokens=24)[0]
    assert res["temperature"] > 0.0
    asr = tw.WhisperASR(model=_port(_peaked(JCFG.token_nospeech)), device="cpu")
    res = asr.transcribe_results(_t(wav[:1]), max_tokens=8)[0]
    assert res["no_speech_prob"] > 0.99 and res["temperature"] == 0.0 and res["silent"] is True
    empty = asr.transcribe_results(torch.zeros(1, 0), max_tokens=8)[0]
    assert empty["silent"] is True and empty["tokens"].size == 0 and empty["windows"] == []
    with pytest.raises(ValueError, match="unsupported"):
        tw.WhisperASR(model=asr.model, language="fr", device="cpu")
    with pytest.raises(ValueError, match="single-window"):
        asr.transcribe_tokens(torch.zeros(1, WINDOW + 1))


def test_fabricated_base_pt_loads_strictly_and_matches_jax(tmp_path, params, mel):
    """OpenAI's file layout (``{"dims", "model_state_dict"}``, torch tensors
    under OpenAI's key names) written to a temp directory: the port loads it
    strictly (its dims give the widths) and computes what JAX's
    ``WhisperASR(weights_path=...)`` computes; a missing key raises."""
    sd = {k: v.clone() for k, v in whisper_state_dict_from_jax(jw.random_whisper_params(JCFG, seed=5)).items()}
    dims = {f.name: getattr(JCFG, f.name) for f in dataclasses.fields(JCFG)}
    path = tmp_path / "base.pt"
    torch.save({"dims": dims, "model_state_dict": sd}, path)
    ours = tw.WhisperASR(weights_path=str(path), device="cpu")
    theirs = jw.WhisperASR(weights_path=str(path), cfg=JCFG)
    assert ours.cfg == TCFG
    want = jw.whisper_encode_jit(theirs.params, jnp.asarray(mel), JCFG)
    assert _rel(tw.whisper_encode(ours.model, _t(mel)).numpy(), want) <= 1e-4
    sd.pop("decoder.ln.bias")
    torch.save({"dims": dims, "model_state_dict": sd}, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        tw.load_whisper(str(path), device="cpu")


def test_entry_points_run_on_the_card_unless_asked():
    """No CPU fallback: the default device is the card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tw.WhisperASR(model=tw.Whisper(TCFG))
