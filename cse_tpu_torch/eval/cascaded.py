"""Cascaded CSE: separate -> ASR each stream -> LLM-score vs the dialog history.

Port of ``cse_tpu/eval/cascaded.py``. The reference's inference-only
pipeline (``test_cascaded.py:145-295``):
1. the base Sepformer separates the mixture into num_spks streams;
2. each stream is resampled 8k->16k, peak-normed to 0.9 and transcribed by
   Whisper-base under the full ``whisper.transcribe`` default policy
   (``models/whisper.py::WhisperASR``; the reference passes no options at
   ``test_cascaded.py:224``);
3. Llama-3-8B scores ``context + transcript``; the per-stream score is the
   mean over transcript positions of the per-position MAX log-softmax, the
   reference's quirk of scoring the argmax token, not the realized one
   (``test_cascaded.py:231``);
4. the argmax stream is the prediction.

Without the released Whisper or Llama assets the stages run stand-ins (a
small random Whisper, a crc32 score), and ``describe()`` says so. Everything
runs on the ASR's device: the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import glob
import os
import zlib

import numpy as np
import torch

from cse_tpu_torch.ops.resample import resample


class CascadedSelector:
    def __init__(self, asr, scorer, tokenizer, whisper_tokenizer=None, sr: int = 8000, asr_max_tokens: int = 224):
        """asr: ``WhisperASR``; scorer: ``(ids, mask) -> logits [B, T, V]``
        or None (the crc32 stand-in); tokenizer: the Llama tokenizer (HF or
        ``ByteTokenizer``); asr_max_tokens: the decode budget of a 30 s window.

        The scorer must be padding-invariant: :meth:`_lm_scores` left-pads
        every row to a shared 128-multiple with mask 0, so logits at unmasked
        positions may not depend on the pad length. The port's Llama
        (``arange`` positions and a key-padding mask) is."""
        self.asr = asr
        self.scorer = scorer
        self.tok = tokenizer
        self.wtok = whisper_tokenizer
        self.sr = sr
        self.asr_max_tokens = int(asr_max_tokens)

    def describe(self) -> str:
        parts = ["whisper=real" if not getattr(self.asr, "is_stub", False) else "whisper=stub",
                 "llm=real" if self.scorer is not None else "llm=stub",
                 "tokenizer=real" if not getattr(self.tok, "is_fallback", False) else "tokenizer=byte"]
        return ",".join(parts)

    def _decode_text(self, token_ids) -> str:
        # timestamp and special ids (>= EOT) are dropped, as whisper's tokenizer.decode does
        token_ids = [int(t) for t in token_ids if int(t) < self.asr.cfg.eot]
        if self.wtok is not None:
            return self.wtok.decode(token_ids).lstrip()
        # pseudo-text stand-in: stable per-token words (plumbing only)
        return " ".join(f"w{int(t) % 997}" for t in token_ids).lstrip()

    def _lm_score(self, context: str, transcript: str) -> float:
        """The mean over transcript positions of the max log-softmax (the reference's quirk)."""
        return self._lm_scores(context, [transcript])[0]

    def _lm_scores(self, context: str, transcripts: list) -> list:
        """Every stream of one mixture scored in one scorer call: the rows
        share the dialog-history prefix and one 128-multiple width, and the
        scores equal per-row calls because the scorer is padding-invariant.
        An empty transcript scores -1e9 and stays out of the call."""
        ctx_ids = self.tok.encode(context)
        cands = [self.tok.encode(t)[1:] for t in transcripts]  # strip bos (:226)
        scores = [-1e9] * len(transcripts)  # empty transcript floor (:229)
        live = [i for i, c in enumerate(cands) if len(c) > 0]
        if not live:
            return scores
        if self.scorer is None:
            # deterministic stand-in score: a stable-hash pseudo likelihood
            tail = context[-64:].encode()
            for i in live:
                h = np.asarray([zlib.crc32(tail + str(t).encode()) % 1000 for t in cands[i]], np.float64)
                scores[i] = float(-(h / 1000.0).mean())
            return scores
        seqs = [ctx_ids + cands[i] for i in live]
        L = ((max(len(s) for s in seqs) + 127) // 128) * 128
        ids = np.zeros((len(live), L), np.int32)
        mask = np.zeros((len(live), L), np.int32)
        for r, s in enumerate(seqs):
            ids[r, L - len(s):] = s
            mask[r, L - len(s):] = 1
        logits = self.scorer(torch.from_numpy(ids), torch.from_numpy(mask))
        # reduced on the scorer's device: only the scores come back
        row_scores = []
        for r, i in enumerate(live):
            n_cand = len(cands[i])
            lp = torch.log_softmax(logits[r, -n_cand:].float(), dim=-1)
            row_scores.append(lp.amax(dim=-1).sum() / n_cand)
        for i, v in zip(live, torch.stack(row_scores).tolist()):
            scores[i] = float(v)
        return scores

    def select(self, candidates_8k, context: str):
        """candidates_8k: [num_spks, T] separated streams of one mixture
        (numpy or a tensor). Returns (best_index, transcripts, scores), the
        reference's ``:216-236``."""
        cand = torch.as_tensor(candidates_8k, dtype=torch.float32).to(self.asr.device)
        cand16, _ = resample(cand, self.sr, 16000)
        peak = cand16.abs().amax(dim=-1, keepdim=True)
        cand16 = cand16 / torch.clamp_min(peak, 1e-9) * 0.9
        results = self.asr.transcribe_results(cand16, max_tokens=self.asr_max_tokens)
        transcripts = []
        for res in results:
            # silence skip: whisper.transcribe emits no segment, so the transcript is empty
            if res["silent"]:
                text = ""
            elif res["text"] is not None:
                text = res["text"]  # the ASR's own decode, which its compression gate saw
            else:
                text = self._decode_text(res["tokens"])
            transcripts.append(text)
        scores = self._lm_scores(context, transcripts)
        return int(np.argmax(scores)), transcripts, scores


def build_cascaded(
    llama_path: str,
    whisper_path: str | None,
    tokenizer,
    sr: int = 8000,
    ctx_scorer=None,
    asr_temperatures: tuple | None = None,
    llama_quant: str | None = None,
    asr_best_of: int | None = None,
    device=None,
):
    """Assemble the cascade from the assets on disk (stand-ins otherwise) on
    ``device`` (the card unless ``device="cpu"``).

    ``whisper_path``: OpenAI's ``base.pt`` file (its directory searched for
    the HF ``WhisperTokenizer`` files) or a directory holding a ``*.pt`` and
    those files. Without the weights the ASR is a random Whisper at the stub
    widths (the real vocabulary and 30 s window, width 64, 4 heads, 2 + 2
    layers) on the greedy rung alone with a 32-token budget. The scorer is
    ``ctx_scorer``, else the Llama under ``llama_path``
    (``LlamaContextEncoder(...).score_logits``, bf16, ``llama_quant``), else
    the crc32 stand-in."""
    from cse_tpu_torch.models.whisper import TRANSCRIBE_TEMPERATURES, WhisperASR, WhisperConfig

    weights_path = None
    tok_dir = None
    if whisper_path and os.path.isdir(whisper_path):
        tok_dir = whisper_path
        pts = sorted(glob.glob(os.path.join(whisper_path, "*.pt")))
        weights_path = pts[0] if pts else None
    elif whisper_path and os.path.exists(whisper_path):
        weights_path = whisper_path
        tok_dir = os.path.dirname(os.path.abspath(whisper_path))

    wtok = None
    try:
        if tok_dir:
            from transformers import WhisperTokenizer

            wtok = WhisperTokenizer.from_pretrained(tok_dir)
    except Exception:
        wtok = None

    is_stub = weights_path is None
    if asr_temperatures:
        temperatures = asr_temperatures
    elif is_stub:
        # random weights fail the -1.0 logprob gate on every row: the full
        # ladder would spend 5 sampled rungs on noise, so pin the greedy rung
        temperatures = (0.0,)
    else:
        temperatures = TRANSCRIBE_TEMPERATURES
    stub_cfg = None
    if is_stub:
        # the real vocabulary (special ids, suppression sets) and 30 s window, small widths
        stub_cfg = WhisperConfig(n_audio_state=64, n_audio_head=4, n_audio_layer=2,
                                 n_text_state=64, n_text_head=4, n_text_layer=2)
    asr_kw = {}
    if asr_best_of is not None:
        asr_kw["best_of"] = int(asr_best_of)
    asr = WhisperASR(
        weights_path=weights_path, cfg=stub_cfg,
        suppress_ids=_non_speech_ids(wtok),
        language=None,
        text_fn=(lambda ids: wtok.decode(ids)) if wtok is not None else None,
        temperatures=temperatures,
        # real weights warm every decode the policy can reach on the first mixture
        precompile=not is_stub,
        device=device,
        **asr_kw,
    )
    if is_stub:
        asr.is_stub = True

    scorer = ctx_scorer
    if scorer is None and os.path.isdir(llama_path):
        from cse_tpu_torch.models.llama import LlamaContextEncoder

        scorer = LlamaContextEncoder(llama_path, quant=llama_quant, device=device).score_logits

    return CascadedSelector(asr, scorer, tokenizer, whisper_tokenizer=wtok, sr=sr,
                            # stub transcripts are pseudo-text: no 224-token windows of noise
                            asr_max_tokens=32 if is_stub else 224)


def _non_speech_ids(wtok) -> tuple:
    """whisper's tokenizer-derived non-speech suppression set (symbols and
    music markers ``transcribe()`` bars by default through
    ``suppress_tokens=-1``); empty without tokenizer assets."""
    if wtok is None:
        return ()
    symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』') + (
        "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪"
    ).split()
    ids = set()
    for sym in symbols + [" -", " '"]:
        for tok in {sym, " " + sym.strip()}:
            try:
                enc = wtok.encode(tok, add_special_tokens=False)
            except Exception:
                continue
            if len(enc) == 1:
                ids.add(int(enc[0]))
    return tuple(sorted(ids))
