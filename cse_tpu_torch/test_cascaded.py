"""Cascaded CSE evaluation: Sepformer -> Whisper ASR -> Llama LM selection.

    python -m cse_tpu_torch.test_cascaded --checkpoint base.ckpt --batch_size 1 --whisper_path base.pt --llama_path <dir>
    python -m cse_tpu_torch.test_cascaded --synthetic_smoke --platform cpu --debug_tiny_model --batch_size 1

The port's counterpart of the root ``test_cascaded.py`` (the same flags;
``--batch_size`` must be 1): a plain (non-contextual) Sepformer separates
each test mixture layer by layer; every stream is transcribed by Whisper and
scored by the Llama against the dialog history (the mean of per-position
max log-softmax, the reference's rule at ``test_cascaded.py:230-231``); the
argmax stream is scored with SI-SNR / SDR (and their improvements) and PESQ,
written to ``test_results_{ds}.txt`` under
``{save_dir}/{ckpt}/Cascaded_{num_test_mix}_speaker_{context_length}_ctx_{ds}``.

A released base-Sepformer ``.ckpt`` comes in through
``compat/torch_import.py``; ``--whisper_path`` (or ``WHISPER_BASE_PT``) and
``--llama_path`` are used when present and stood in for otherwise, which the
banner says. Runs on the card unless ``--platform cpu`` is given, and raises
without one. ``--debug_tiny_model`` separates with the trainer's tiny model,
which the root ``test_cascaded.py`` does not offer.
"""

from __future__ import annotations

import os
from types import SimpleNamespace


def build_base_separator(args, device):
    """The base Sepformer on ``device`` from ``--checkpoint`` (a released
    ``.ckpt``, whose keys give num_spks and the depths, or one of this
    package); random init (seed 0) only under ``--synthetic_smoke``."""
    import torch

    from cse_tpu_torch.compat.torch_import import infer_reference_config, sepformer_from_state_dict
    from cse_tpu_torch.core.cli import TINY_MODEL
    from cse_tpu_torch.models import Sepformer, SepformerConfig
    from cse_tpu_torch.train import checkpoint as ckpt_lib

    kw = dict(num_spks=args.num_max_mix, variant="base", **(TINY_MODEL if args.debug_tiny_model else {}))
    restored = None
    if args.checkpoint:
        restored = ckpt_lib.restore_checkpoint(args.checkpoint)
        if "state_dict" in restored:
            kw["num_spks"] = infer_reference_config(restored["state_dict"])["num_spks"]
    elif not args.synthetic_smoke:
        raise SystemExit("Please specify checkpoint path (--checkpoint)")
    cfg = SepformerConfig(**kw)
    model = Sepformer(cfg, generator=torch.Generator().manual_seed(0))
    if restored is not None:
        if "state_dict" in restored:
            model.load_state_dict(sepformer_from_state_dict(restored["state_dict"], cfg.num_dp_layers,
                                                            cfg.num_tf_layers))
        else:
            model.load_state_dict(restored["model"])
    return model.to(device).eval()


def main(argv=None) -> dict:
    import numpy as np
    import torch

    from cse_tpu_torch.core.banner import announce_assets
    from cse_tpu_torch.core.cli import corpus_paths
    from cse_tpu_torch.data.pipeline import EvalLoader, PipelineConfig, prefetch
    from cse_tpu_torch.data.tokenizer import load_tokenizer
    from cse_tpu_torch.eval.cascaded import build_cascaded
    from cse_tpu_torch.eval.metrics import SdrMetric, SiSnrMetric
    from cse_tpu_torch.eval.pesq import PesqMetric
    from cse_tpu_torch.test import setup_test_args

    args, dev = setup_test_args(argv)
    if args.batch_size != 1:
        raise ValueError(f"cascaded eval runs at --batch_size 1 (reference :103), got {args.batch_size}")
    model = build_base_separator(args, dev)

    tokenizer = load_tokenizer(args.llama_path, args.llama_auth_token)
    whisper_path = args.whisper_path or os.environ.get("WHISPER_BASE_PT")
    temps = tuple(float(t) for t in args.asr_temperature.split(",")) if args.asr_temperature else None
    cascade = build_cascaded(
        args.llama_path, whisper_path, tokenizer, sr=args.sr, asr_temperatures=temps,
        llama_quant=("w8a8" if args.llama_w8a8 else "int8" if args.llama_int8 else None),
        asr_best_of=args.asr_best_of, device=dev,
    )
    print(f"[cse_tpu_torch] cascaded stages: {cascade.describe()}")
    announce_assets("test", args, tokenizer=tokenizer, whisper=cascade.asr,
                    llm=SimpleNamespace(is_stub=cascade.scorer is None))

    pcfg = PipelineConfig(
        max_sp_len=args.max_sp_len, sr=args.sr, num_max_mix=args.num_max_mix,
        context_length=args.context_length, max_ctx_tokens=args.max_ctx_tokens,
        ctx_buckets=tuple(args.ctx_buckets or ()),
    )
    loader = EvalLoader(corpus_paths(args), args.test_dataset, "test", pcfg, tokenizer, batch_size=1,
                        num_test_mix=args.num_test_mix, num_workers=args.workers, device=dev)
    print(f"Num test files: {len(loader)}")

    m_sisnr, m_sdr = SiSnrMetric(), SdrMetric()
    m_sisnr_p, m_sdr_p = SiSnrMetric(), SdrMetric()
    m_pesq = PesqMetric(sr=args.sr)
    try:
        # the next mixture's decode overlaps this one's separator, ASR and scorer
        for i, batch in enumerate(prefetch(loader.batches(), depth=2)):
            mixed = batch["mixed"]
            with torch.no_grad():
                est = model(mixed)  # [1, T, spk]
            cands = est[0].t()  # [spk, T]
            idx, transcripts, scores = cascade.select(cands, batch["contexts"][0])
            enhanced = cands[None, idx].double().cpu().numpy()
            gt = batch["gt"].double().cpu().numpy()
            mixed = mixed.double().cpu().numpy()
            m_sisnr.update(enhanced, gt)
            m_sdr.update(enhanced, gt)
            m_sisnr_p.update(mixed, gt)
            m_sdr_p.update(mixed, gt)
            m_pesq.update(enhanced, gt, lengths=batch["sp_len"].cpu().numpy())
            if i % 20 == 0:
                print(f"******** Test ({args.test_dataset}) : {i + 1} / {len(loader)} ********")
    finally:
        loader.close()

    res = {
        "si_snr": m_sisnr.compute(),
        "sdr": m_sdr.compute(),
        "si_snr_i": m_sisnr.compute() - m_sisnr_p.compute(),
        "sdr_i": m_sdr.compute() - m_sdr_p.compute(),
        "pesq": m_pesq.compute(),
        "n": m_sisnr.count,
    }
    print("## Test SI-SNR: ", res["si_snr"])
    print("## Test SDR: ", res["sdr"])
    print("## Test SI-SNR-i: ", res["si_snr_i"])
    print("## Test SDR-i: ", res["sdr_i"])
    print("## Test PESQ-p862: ", res["pesq"])

    ckpt_tag = (
        os.path.join(*os.path.normpath(os.path.splitext(args.checkpoint)[0]).split(os.sep)[-2:])
        if args.checkpoint else "random_init"
    )
    dir_name = f"Cascaded_{args.num_test_mix}_speaker_{args.context_length}_ctx_{args.test_dataset}"
    out = os.path.join(args.save_dir, ckpt_tag, dir_name)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"test_results_{args.test_dataset}.txt"), "w") as f:
        f.write(f"Test SI-SNR: {res['si_snr']}\n")
        f.write(f"Test SDR: {res['sdr']}\n")
        f.write(f"Test SI-SNR-i: {res['si_snr_i']}\n")
        f.write(f"Test SDR-i: {res['sdr_i']}\n")
        f.write(f"Test PESQ-p862: {res['pesq']}\n")
    return res


if __name__ == "__main__":
    main()
