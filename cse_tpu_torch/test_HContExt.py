"""Evaluate H-ContExt with cue ablations (--cue joint|history|voice).

    python -m cse_tpu_torch.test_HContExt --checkpoint model.ckpt --ecapa_path embedding_model.ckpt --fused_eval
    python -m cse_tpu_torch.test_HContExt --synthetic_smoke --platform cpu --debug_tiny_model --cue voice

The port's counterpart of the root ``test_HContExt.py`` (the same flags):
ContExt evaluation plus enrollment speaker embeddings, attached to each
batch by ``evaluate``'s ``prepare_batch`` under the reference's eval rules
(``eval/enrollment.py``; ``--one_sec``: a 1 s crop of the gt for every
corpus). ``--cue`` reproduces the paper's history-only / voice-only
ablations; the results go under
``{save_dir}/{ckpt}/{num_test_mix}_speaker_{context_length}_ctx_{cue}``.
``--ecapa_path`` takes the released speechbrain ``embedding_model.ckpt``
(without it the spectral stand-in embeds, and the banner says so).

Runs on the card unless ``--platform cpu`` is given, and raises without one.
The model, the test set and the evaluation are ``cse_tpu_torch.test``'s
(``--fused_eval``, ``--debug_tiny_model`` as there). The imports sit inside
the function: the metric workers (spawned processes) import this module as
their ``__main__`` and must load no torch.
"""

from __future__ import annotations


def main(argv=None) -> dict:
    from cse_tpu_torch.core.banner import announce_assets
    from cse_tpu_torch.core.cli import corpus_paths
    from cse_tpu_torch.data.tokenizer import load_tokenizer
    from cse_tpu_torch.eval.enrollment import eval_enrollment_embeddings
    from cse_tpu_torch.models.context_encoder import build_context_encoder
    from cse_tpu_torch.models.speaker_encoder import build_speaker_encoder
    from cse_tpu_torch.test import build_test_model, run_test_set, setup_test_args
    from cse_tpu_torch.train.step import TrainConfig, make_eval_step

    args, dev = setup_test_args(argv)
    model, mcfg = build_test_model(args, dev, add_se=True)
    encoder = build_speaker_encoder(args.ecapa_path, dev)
    tokenizer = load_tokenizer(args.llama_path, args.llama_auth_token)
    llm = build_context_encoder(
        args.llama_path, ctx_length=args.ctx_length, auth_token=args.llama_auth_token,
        quant=("w8a8" if args.llama_w8a8 else "int8" if args.llama_int8 else None),
        device=dev,
    )
    announce_assets("test", args, tokenizer=tokenizer, llm=llm, ecapa_path=args.ecapa_path)
    llm_fn, llm_ps = llm.pure()
    eval_step = make_eval_step(model, TrainConfig(variant="hcontext", num_spks=mcfg.num_spks), cue=args.cue,
                               fused=args.fused_eval, device=dev, llm_apply=llm_fn, llm_params=llm_ps)
    paths = corpus_paths(args)

    def prepare_batch(batch):
        """Attach the enrollment embeddings (reference rules, dataset :375-391)."""
        batch["se"] = eval_enrollment_embeddings(
            batch, args.test_dataset, "test", paths, encoder,
            num_test_mix=args.num_test_mix, seed=args.seed, one_sec=args.one_sec,
        )
        return batch

    return run_test_set(args, dev, tokenizer, eval_step,
                        f"{args.num_test_mix}_speaker_{args.context_length}_ctx_{args.cue}", prepare_batch)


if __name__ == "__main__":
    main()
