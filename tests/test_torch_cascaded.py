"""The port's cascaded selector (``cse_tpu_torch/eval/cascaded.py``) and its
entry point ``python -m cse_tpu_torch.test_cascaded`` on the CPU, against
cse_tpu's (tests/test_cascaded.py's cases): the scoring quirk (the mean of
per-position MAX log-softmax) on a tiny ``transformers`` Llama saved to a
temp directory and loaded by both packages' ``LlamaContextEncoder`` in fp32
(1e-4); ``select`` end to end on the same stub-width Whisper (index and
transcripts equal, scores 1e-4); batched scores equal to per-row ones (the
scorer's padding invariance); the crc32 stand-in equal to JAX's; a silent
stream gives an empty transcript and the -1e9 floor; ``build_cascaded``'s
choices; the entry point on the synthetic corpus."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cse_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from cse_tpu.eval import cascaded as jc
from cse_tpu.models import whisper as jw
from cse_tpu.models.llama import LlamaContextEncoder as JaxLlama
from cse_tpu_torch import test_cascaded as cli
from cse_tpu_torch.compat.jax_params import whisper_state_dict_from_jax
from cse_tpu_torch.data.tokenizer import ByteTokenizer
from cse_tpu_torch.eval import cascaded as tc
from cse_tpu_torch.models import whisper as tw
from cse_tpu_torch.models.llama import LlamaContextEncoder

torch.set_num_threads(1)

JCFG = jw.WhisperConfig(n_audio_state=64, n_audio_head=4, n_audio_layer=2,
                        n_text_state=64, n_text_head=4, n_text_layer=2)
TCFG = tw.WhisperConfig(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(JCFG)})
CONTEXT = "Speaker 0: how are you/nSpeaker 1: "


@pytest.fixture(scope="module")
def llama_dir(tmp_path_factory):
    from transformers import LlamaConfig as HFConfig
    from transformers import LlamaForCausalLM

    torch.manual_seed(0)
    cfg = HFConfig(vocab_size=300, hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                   num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
                   tie_word_embeddings=False)
    d = tmp_path_factory.mktemp("llama_sc")
    LlamaForCausalLM(cfg).save_pretrained(str(d), safe_serialization=True)
    return str(d)


@pytest.fixture(scope="module")
def scorers(llama_dir):
    return (JaxLlama(llama_dir, dtype=jnp.float32).score_logits,
            LlamaContextEncoder(llama_dir, dtype=torch.float32, device="cpu").score_logits)


def _asrs(params, **kw):
    return (jw.WhisperASR(params=params, cfg=JCFG, **kw),
            tw.WhisperASR(model=tw.whisper_from_state_dict(whisper_state_dict_from_jax(params), TCFG, "cpu"),
                          device="cpu", **kw))


@pytest.fixture(scope="module")
def asrs():
    return _asrs(jw.random_whisper_params(JCFG, seed=3), temperatures=(0.0,), language=None)


def test_lm_score_quirk_matches_jax(asrs, scorers):
    """The score is the mean over transcript positions of the per-position
    max log-softmax, not the realized token's; an empty transcript -1e9."""
    jsel = jc.CascadedSelector(asrs[0], scorers[0], JaxByteTokenizer())
    sel = tc.CascadedSelector(asrs[1], scorers[1], ByteTokenizer())
    for ctx, cand in (("hello there", "hi"), (CONTEXT, "fine thanks and you")):
        score = sel._lm_score(ctx, cand)
        np.testing.assert_allclose(score, jsel._lm_score(ctx, cand), rtol=1e-4, atol=1e-4)
        ids = ByteTokenizer().encode(ctx) + ByteTokenizer().encode(cand)[1:]
        n = len(cand.encode())
        logits = scorers[1](torch.tensor([ids]), torch.ones(1, len(ids), dtype=torch.int32))
        want = float(torch.log_softmax(logits[0, -n:], dim=-1).amax(dim=-1).mean())
        assert abs(score - want) < 1e-5
    assert sel._lm_score("ctx", "") == -1e9


def test_batched_scores_match_per_row(asrs, scorers):
    """One [n, L] scorer call a mixture equals per-row calls: the shared
    128-multiple left pad changes no row's score; empty rows keep -1e9."""
    sel = tc.CascadedSelector(asrs[1], scorers[1], ByteTokenizer())
    transcripts = ["fine thanks and you", "", "what did you just say to me"]
    batch = sel._lm_scores(CONTEXT, transcripts)
    assert batch[1] == -1e9
    np.testing.assert_allclose(batch, [sel._lm_score(CONTEXT, t) for t in transcripts], rtol=1e-5, atol=1e-6)
    jsel = jc.CascadedSelector(asrs[0], scorers[0], JaxByteTokenizer())
    np.testing.assert_allclose(batch, jsel._lm_scores(CONTEXT, transcripts), rtol=1e-4, atol=1e-4)


def test_stub_scorer_matches_jax(asrs):
    sel = tc.CascadedSelector(asrs[1], None, ByteTokenizer())
    jsel = jc.CascadedSelector(asrs[0], None, JaxByteTokenizer())
    transcripts = ["some words here", "", "w12 w907 w3"]
    assert sel._lm_scores(CONTEXT, transcripts) == jsel._lm_scores(CONTEXT, transcripts)
    assert sel.describe() == jsel.describe() == "whisper=real,llm=stub,tokenizer=byte"


@pytest.mark.parametrize("with_llm", [False, True])
def test_select_end_to_end_matches_jax(asrs, scorers, with_llm):
    """Two 2 s streams at 8 kHz: resampled, peak-normed, transcribed (the
    language detected), scored; the same choice, transcripts and scores."""
    cands = (np.random.default_rng(4).standard_normal((2, 16000)) * 0.3).astype(np.float32)
    jsel = jc.CascadedSelector(asrs[0], scorers[0] if with_llm else None, JaxByteTokenizer(), asr_max_tokens=32)
    sel = tc.CascadedSelector(asrs[1], scorers[1] if with_llm else None, ByteTokenizer(), asr_max_tokens=32)
    want = jsel.select(cands, CONTEXT)
    got = sel.select(torch.from_numpy(cands), CONTEXT)
    assert got[0] == want[0] and got[1] == want[1]
    assert all(t for t in got[1])  # random weights transcribe noise as pseudo-text
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-4)


def test_silent_stream_gives_an_empty_transcript():
    """A <|nospeech|> winner: whisper.transcribe emits no segment, so the
    transcript is empty and the score the -1e9 floor, as in JAX."""
    params = jw.random_whisper_params(JCFG, 0)
    b = np.linspace(0.5, 1.5, 64).astype(np.float32)
    params["dec_ln"] = {"scale": np.zeros(64, np.float32), "bias": b}
    params["tok_emb"] = params["tok_emb"] * 0.001
    params["tok_emb"][JCFG.token_nospeech] = 10.0 * b
    jasr, asr = _asrs(params)
    cands = np.random.default_rng(5).standard_normal((2, 16000)).astype(np.float32)
    got = tc.CascadedSelector(asr, None, ByteTokenizer()).select(cands, "hello there")
    want = jc.CascadedSelector(jasr, None, JaxByteTokenizer()).select(cands, "hello there")
    assert got[1] == want[1] == ["", ""] and got[2] == want[2] == [-1e9, -1e9]


def test_build_cascaded_matches_jax_choices(tmp_path, llama_dir):
    """No assets: the stub Whisper (the real vocabulary and window, width 64),
    the greedy rung, a 32-token budget, the crc32 stand-in; a ``base.pt`` in
    a ``--whisper_path`` directory and a Llama directory: the real Whisper
    under the whole ladder, 224 tokens, the Llama's logits."""
    stub = tc.build_cascaded("__none__", None, ByteTokenizer(), device="cpu")
    jstub = jc.build_cascaded("__none__", None, JaxByteTokenizer())
    assert stub.describe() == jstub.describe() == "whisper=stub,llm=stub,tokenizer=byte"
    assert stub.asr.cfg == TCFG and stub.asr.language is None and not stub.asr.precompile
    assert (stub.asr.temperatures, stub.asr_max_tokens) == (jstub.asr.temperatures, jstub.asr_max_tokens) == ((0.0,), 32)
    sd = tw.random_whisper_params(TCFG, 1)
    torch.save({"dims": dataclasses.asdict(TCFG), "model_state_dict": sd}, tmp_path / "base.pt")
    real = tc.build_cascaded(llama_dir, str(tmp_path), ByteTokenizer(), asr_best_of=2, device="cpu")
    assert real.describe() == "whisper=real,llm=real,tokenizer=byte"
    assert real.asr.temperatures == tw.TRANSCRIBE_TEMPERATURES and real.asr_max_tokens == 224
    assert real.asr.precompile and real.asr.best_of == 2 and real.asr.cfg == TCFG
    assert torch.equal(real.asr.model.decoder.token_embedding.weight, sd["decoder.token_embedding.weight"])
    assert tc._non_speech_ids(None) == jc._non_speech_ids(None) == ()


def test_test_cascaded_on_the_cpu(tmp_path):
    """``python -m cse_tpu_torch.test_cascaded --synthetic_smoke
    --debug_tiny_model --platform cpu``: the results file, n equal to the
    test set's size, finite metrics; --batch_size other than 1 refused."""
    argv = ["--synthetic_smoke", "--debug_tiny_model", "--platform", "cpu", "--mode", "test", "--train_data",
            "dailytalk", "--max_sp_len", "2", "--max_ctx_tokens", "16", "--workers", "2", "--synthetic_eval", "4",
            "--save_dir", str(tmp_path)]
    res = cli.main(argv + ["--batch_size", "1"])
    assert res["n"] == 4
    assert all(math.isfinite(res[k]) for k in ("si_snr", "sdr", "si_snr_i", "sdr_i", "pesq"))
    out = tmp_path / "random_init" / "Cascaded_2_speaker_0_ctx_dailytalk" / "test_results_dailytalk.txt"
    assert "Test PESQ-p862:" in out.read_text()
    with pytest.raises(ValueError, match="batch_size 1"):
        cli.main(argv + ["--batch_size", "2"])


def test_test_cascaded_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--synthetic_smoke", "--batch_size", "1", "--mode", "test"])
