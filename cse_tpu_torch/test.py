"""Evaluate ContSep / ContExt on released premixed test sets.

    python -m cse_tpu_torch.test --checkpoint model.ckpt --test_model ContExt --fused_eval
    python -m cse_tpu_torch.test --synthetic_smoke --platform cpu --debug_tiny_model

The port's counterpart of the root ``test.py`` (the same flags): loads a
checkpoint (a released PyTorch ``.ckpt`` of the reference or one of this
package), runs the whole test set, reports SI-SNR / SDR / improvements /
PESQ / stream-selection accuracy, and writes ``test_results_{ds}.txt`` +
``acc_{ds}.txt`` under
``{save_dir}/{ckpt}/{num_test_mix}_speaker_{context_length}_ctx``.

Runs on the card unless ``--platform cpu`` is given, and raises without one.
``--fused_eval`` runs the separator through the fused serving forward (the
stack kernels); otherwise the layer-by-layer model (``--flash_attention``:
the flash kernels). ``--debug_tiny_model`` evaluates the trainer's tiny
model, which the root ``test.py`` does not offer.

The imports sit inside the functions: the metric workers (spawned processes)
import this module as their ``__main__`` and must load no torch.
"""

from __future__ import annotations

import os

from cse_tpu_torch.core.flags import parse_test_args


def build_test_model(args, device, add_se: bool = False):
    """(model on ``device``, its config) from ``--checkpoint``; random init
    (seed 0) only under ``--synthetic_smoke``.

    A released checkpoint gives num_spks, ce and variant (through
    ``infer_reference_config``); every other width is the flags' (the
    paper's, or the tiny model's under ``--debug_tiny_model``), as in the
    root ``test.py``. ``add_se``: the H-ContExt model (ContExt with the
    speaker-embedding cue; ``--test_model`` is not read)."""
    import torch

    from cse_tpu_torch.compat.torch_import import infer_reference_config, sepformer_from_state_dict
    from cse_tpu_torch.models import Sepformer, SepformerConfig
    from cse_tpu_torch.core.cli import TINY_MODEL
    from cse_tpu_torch.train import checkpoint as ckpt_lib

    if not add_se and args.test_model not in ("ContExt", "ContSep"):
        raise ValueError(f"--test_model must be ContExt or ContSep, got {args.test_model!r}")
    kw = dict(
        num_spks=args.num_max_mix,
        variant="context" if add_se or args.test_model == "ContExt" else "contsep",
        add_se=add_se,
        ce=args.test_dataset != "dailytalk",
        compute_dtype=torch.bfloat16 if (args.bf16 or args.fp16) else torch.float32,
        use_flash_attention=args.flash_attention,
        **(TINY_MODEL if args.debug_tiny_model else {}),
    )
    restored = None
    if args.checkpoint:
        restored = ckpt_lib.restore_checkpoint(args.checkpoint)
        if "state_dict" in restored:
            inferred = infer_reference_config(restored["state_dict"])
            kw.update(num_spks=inferred["num_spks"], ce=inferred["ce"], variant=inferred["variant"])
    elif not args.synthetic_smoke:
        raise SystemExit("Please specify checkpoint path (--checkpoint)")
    cfg = SepformerConfig(**kw)
    model = Sepformer(cfg, generator=torch.Generator().manual_seed(0))
    if restored is not None:
        if "state_dict" in restored:
            model.load_state_dict(sepformer_from_state_dict(
                restored["state_dict"], cfg.num_dp_layers, cfg.num_tf_layers))
        else:
            model.load_state_dict(restored["model"])
    return model.to(device).eval(), cfg


def setup_test_args(argv=None):
    """(parsed flags, device): the card unless ``--platform cpu``;
    ``--synthetic_smoke`` builds its corpus and tests on it."""
    from cse_tpu_torch.core.cli import device_of, setup_synthetic

    args = parse_test_args(argv)
    dev = device_of(args)
    if args.synthetic_smoke:
        setup_synthetic(args)
        args.test_dataset = args.train_data
    if args.mode != "test":
        raise ValueError(f"--mode must be test, got {args.mode!r}")
    return args, dev


def run_test_set(args, dev, tokenizer, eval_step, dir_name: str, prepare_batch=None) -> dict:
    """Score ``--test_dataset``'s test set with ``eval_step`` and write the
    result files under ``{save_dir}/{ckpt}/{dir_name}``."""
    from cse_tpu_torch.core.cli import corpus_paths
    from cse_tpu_torch.data.pipeline import EvalLoader, PipelineConfig
    from cse_tpu_torch.eval.evaluator import evaluate

    pcfg = PipelineConfig(
        max_sp_len=args.max_sp_len, sr=args.sr, num_max_mix=args.num_max_mix,
        context_length=args.context_length, max_ctx_tokens=args.max_ctx_tokens,
        ctx_buckets=tuple(args.ctx_buckets or ()),
    )
    loader = EvalLoader(
        corpus_paths(args), args.test_dataset, "test", pcfg, tokenizer, args.batch_size,
        num_test_mix=args.num_test_mix, num_workers=args.workers, device=dev,
    )
    print(f"Num test files: {len(loader)}")

    if args.checkpoint:
        ckpt_tag = os.path.join(
            *os.path.normpath(os.path.splitext(args.checkpoint)[0]).split(os.sep)[-2:]
        )
    else:
        ckpt_tag = "random_init"
    try:
        return evaluate(
            eval_step, loader, sr=args.sr,
            save_dir=os.path.join(args.save_dir, ckpt_tag), dir_name=dir_name,
            test_dataset=args.test_dataset, generate_speech=args.generate_speech,
            prepare_batch=prepare_batch,
            metric_workers=args.metric_workers,
            prev_cache_dir=(os.path.join(args.save_dir, "prev_metrics_cache")
                            if args.prev_cache else None),
        )
    finally:
        loader.close()


def main(argv=None) -> dict:
    from cse_tpu_torch.core.banner import announce_assets
    from cse_tpu_torch.data.tokenizer import load_tokenizer
    from cse_tpu_torch.models.context_encoder import build_context_encoder
    from cse_tpu_torch.train.step import TrainConfig, make_eval_step

    args, dev = setup_test_args(argv)
    model, mcfg = build_test_model(args, dev)
    tokenizer = load_tokenizer(args.llama_path, args.llama_auth_token)
    # ContSep consumes the final hidden state only (reference test.py:226).
    # ContExt honours --ctx_length as training does; the reference's test.py
    # takes [:, -1:], which mis-evaluates ctx_length > 1 models (a recorded
    # deviation; the same at the default 1).
    llm = build_context_encoder(
        args.llama_path,
        ctx_length=1 if mcfg.variant == "contsep" else args.ctx_length,
        auth_token=args.llama_auth_token,
        quant=("w8a8" if args.llama_w8a8 else "int8" if args.llama_int8 else None),
        device=dev,
    )
    announce_assets("test", args, tokenizer=tokenizer, llm=llm)
    tcfg = TrainConfig(
        variant="contsep" if mcfg.variant == "contsep" else "context",
        num_spks=mcfg.num_spks, use_ce=mcfg.ce,
    )
    llm_fn, llm_ps = llm.pure()
    eval_step = make_eval_step(model, tcfg, fused=args.fused_eval, device=dev,
                               llm_apply=llm_fn, llm_params=llm_ps)
    return run_test_set(args, dev, tokenizer, eval_step, f"{args.num_test_mix}_speaker_{args.context_length}_ctx")


if __name__ == "__main__":
    main()
